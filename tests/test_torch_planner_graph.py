"""The planner's graph route on the CPU (`planner.planner.device_call`,
``BoundPlanner``/``BatchBroker``/``PhaseSyncBroker`` with ``graph=``).

On the card every planner device call replays one CUDA graph per kernel
key, static arguments and input signature, shared by the process. What
the CPU can hold of it:

- (a) capture safety: each key's graph body (copy-in, the function on the
  static inputs, clone-out) runs under ``torch_host_guard.host_guard`` at
  widths 1 and 2 in float32 and float64; the via-rotation NLP at k = 1
  and 2, width 1 in float64 and width 2 in float32;
- (b) each key's graph body through a broker (``graph = True`` set on a
  CPU ``PhaseSyncBroker``, two workers: width 2) equals the eager call at
  that width bit for bit;
- (c) one plan of ``test_torch_planner.py``'s scene (float64) through
  the graph bodies equals the eager plan bit for bit, and matches the JAX
  planner at that file's tolerance;
- (d) 8 threads calling one key of a shared broker through the graph each
  get their own row (the graph's lock keeps value semantics);
- (e) two planners share one graph per (key, width);
- (f) the CPU default is eager, and ``graph=True`` on the CPU raises.

The inputs are each key's first calls in the eager plan of (c).
"""

import sys
import threading

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

import torch

from boundplanner_tpu.planner import BoundPlanner as JaxPlanner
from boundplanner_tpu_torch.mpc.graph import Graph
from boundplanner_tpu_torch.parallel.broker import BatchBroker, register_planner_kernels
from boundplanner_tpu_torch.parallel.sync_broker import PhaseSyncBroker
from boundplanner_tpu_torch.planner import planner as tplanner
from boundplanner_tpu_torch.planner.device_search import roadmap_adjacency, shortest_path_device
from boundplanner_tpu_torch.utils.tree import to_numpy, tree_map
from torch_host_guard import host_guard

torch.set_num_threads(1)
TOL = 1e-6          # tests/test_torch_planner.py's
OBSTACLES = [
    [0.25, -0.15, 0.0, 0.45, 0.15, 0.8],   # wall between start and goal
    [-0.5, -0.5, 0.0, -0.3, -0.3, 0.3],
]
KW = dict(e_p_max=0.5, obstacles=OBSTACLES, workspace_max=[1.0, 1.0, 1.0],
          workspace_min=[-1.0, -1.0, 0.0], seed=0)
P0 = np.array([0.0, 0.0, 0.4])
P1 = np.array([0.7, 0.0, 0.4])
R0 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()
R1 = R.from_euler("XYZ", [0, 45, 0], degrees=True).as_matrix()
KEYS = ("fsap", "fsap_mid", "fsl", "mvie", "feas", "fit_ee", "proj", "spath")


def plan(graph: bool, record=None):
    """The scene planned in float64 on the CPU, each device call eagerly or
    through its graph body; ``record`` collects each key's calls (one
    call's arguments as numpy) and their functions."""
    real = tplanner.device_call

    def recording(key, fn, inputs, graph):
        record.setdefault(key, (fn, []))[1].append(tree_map(lambda t: t[0].numpy(), inputs))
        return real(key, fn, inputs, graph)

    planner = tplanner.BoundPlanner(**KW, device="cpu", dtype=torch.float64)
    planner.graph = graph
    if record is not None:
        tplanner.device_call = recording
    try:
        return planner, planner.plan_convex_set_path(P0, P1, R0, R1)
    finally:
        tplanner.device_call = real


@pytest.fixture(scope="module")
def eager():
    calls = {}
    planner, result = plan(False, calls)
    calls["fsap"] = (tplanner.planner_kernels(20)["fsap"], calls["fsap_mid"][1])
    calls["spath"] = (shortest_path_device,
                      [(roadmap_adjacency(planner.roadmap, tplanner.SPATH_PAD),)])
    # the one-via NLP: the first via of the two-via problem
    x0, p0, p1, l_ee, om_n, om, w_size, a_i, b_i, a_v, b_v = calls["via_rot_2"][1][0]
    calls["via_rot_1"] = (tplanner.via_rot_kernel(1),
                          [(x0[:4], p0, p1, l_ee, om_n, om, w_size[:2], a_i[:1], b_i[:1],
                            a_v[:2], b_v[:2])])
    return planner, result, calls


def batch(calls, key, width, dtype):
    """(function, inputs): the key's first ``width`` calls stacked (the
    first again where it had fewer), floating leaves in ``dtype``."""
    fn, args = calls[key]
    rows = [args[min(i, len(args) - 1)] for i in range(width)]
    stacked = tree_map(lambda *xs: torch.from_numpy(np.stack(xs)), *rows)
    return fn, tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, stacked)


def leaves(tree):
    out = []
    tree_map(lambda x: out.append(np.asarray(x)), tree)
    return out


def assert_equal(got, ref):
    got, ref = leaves(got), leaves(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


GUARD_CASES = ([(key, width, dtype) for key in KEYS for width in (1, 2)
                for dtype in (torch.float32, torch.float64)]
               + [(f"via_rot_{k}", width, dtype) for k in (1, 2)
                  for width, dtype in ((1, torch.float64), (2, torch.float32))])


@pytest.mark.parametrize("key,width,dtype", GUARD_CASES,
                         ids=[f"{k}-w{w}-{str(d)[-7:]}" for k, w, d in GUARD_CASES])
def test_key_is_capture_safe(eager, key, width, dtype):
    """(a) No host data and no host read inside the key's graph body."""
    fn, inputs = batch(eager[2], key, width, dtype)
    runner = Graph(fn, inputs)
    with host_guard():
        out = runner(*inputs)
    for leaf in leaves(out):
        assert leaf.shape[0] == width
    assert all(np.isfinite(leaf).all() for leaf in leaves(out) if leaf.dtype.kind == "f"
               and key not in ("spath",))


@pytest.mark.parametrize("key", KEYS + ("via_rot_1",))
def test_broker_graph_body_equals_eager(eager, key):
    """(b) Two workers of a phase-synchronous broker meet at width 2; the
    graph body's rows equal the eager call's rows bit for bit."""
    calls = eager[2]
    brk = PhaseSyncBroker(max_batch=4, device="cpu", dtype=torch.float64)
    register_planner_kernels(brk, max_set_size=20, device_search=True)
    brk.graph = True
    args = [calls[key][1][min(i, len(calls[key][1]) - 1)] for i in range(2)]
    out = [None, None]

    def worker(i):
        try:
            out[i] = brk.call(key, *args[i])
        finally:
            brk.worker_exit()

    for _ in range(2):
        brk.worker_enter()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert brk.stats["width_hist"] == {2: 1}
    fn, inputs = batch(calls, key, 2, torch.float64)
    ref = to_numpy(fn(*inputs))
    for i in range(2):
        assert_equal(out[i], tree_map(lambda leaf: leaf[i], ref))


@pytest.fixture(scope="module")
def body_plan():
    return plan(True)


def test_plan_through_graph_bodies_equals_eager(eager, body_plan):
    """(c) The plan through each key's graph body equals the eager plan
    bit for bit (vias, rotations, bases, sets); the graphs are the
    process's (the via-rotation NLP's among them)."""
    assert_equal(body_plan[1], eager[1])
    assert body_plan[0].nr_sets == eager[0].nr_sets
    keys = {s["key"] for s in tplanner.graph_stats()}
    assert {"fsap_mid", "fsl", "mvie", "feas", "fit_ee", "proj", "via_rot_2"} <= keys


def test_plan_through_graph_bodies_matches_jax(body_plan):
    """(c) ... and matches the JAX planner at test_torch_planner.py's
    tolerance, with the same via and set counts."""
    jp = JaxPlanner(**KW)
    pv_j, rv_j, bp_j, sets_j = jp.plan_convex_set_path(P0, P1, R0, R1)
    tp, (pv_t, rv_t, bp_t, sets_t) = body_plan
    assert len(pv_t) == len(pv_j) and tp.nr_sets == jp.nr_sets
    for got, ref in ((pv_t, pv_j), (rv_t, rv_j), (bp_t, bp_j)):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(np.asarray(g, float), np.asarray(r, float),
                                       rtol=TOL, atol=TOL)
    for (ga, gb), (ra, rb) in zip(sets_t, sets_j):
        np.testing.assert_allclose(ga, ra, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(gb, rb, rtol=TOL, atol=TOL)


def test_concurrent_callers_get_their_own_rows(eager):
    """(d) 8 threads x 4 calls of "proj" (each its own set offset and
    target) through one broker's graph, with no linger and batches of one:
    leaders of one key and width run at once on one graph, the thread
    switch interval at 1 us. Every caller gets its own result: the eager
    call of its own input (every leaf, to 1e-12)."""
    fn, args = eager[2]["proj"][0], eager[2]["proj"][1][0]
    brk = BatchBroker(linger=0.0, max_batch=1, device="cpu", dtype=torch.float64)
    register_planner_kernels(brk)
    brk.graph = True
    calls = {(i, j): (args[0], args[1] + 0.01 * (4 * i + j),
                      np.array([0.1 * i, -0.05 * j, 0.3])) for i in range(8) for j in range(4)}
    out, errors = {}, []

    def work(i):
        try:
            for j in range(4):
                out[i, j] = brk.call("proj", *calls[i, j])
        except Exception as err:  # reported below
            errors.append(err)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert brk.calls_served == 32
    for (i, j), sol in out.items():
        ref = to_numpy(fn(*(torch.from_numpy(np.asarray(a)[None]) for a in calls[i, j])))
        for g, r in zip(leaves(sol), leaves(tree_map(lambda leaf: leaf[0], ref))):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-12)


def test_planners_share_one_graph_per_key_and_width(eager):
    """(e) Two planners (and a broker at the same width) run "feas" through
    one graph: the second and third callers add none."""
    a_p, b_p = eager[2]["feas"][1][0]
    count = lambda: sum(s["key"] == "feas" and s["batch"] == 1 and s["dtype"] == "float64"
                        for s in tplanner.graph_stats())
    first = tplanner.BoundPlanner(**KW, device="cpu", dtype=torch.float64)
    second = tplanner.BoundPlanner(**KW, device="cpu", dtype=torch.float64)
    brk = BatchBroker(linger=0.0, device="cpu", dtype=torch.float64)
    register_planner_kernels(brk)
    for obj in (first, second, brk):
        obj.graph = True
    first._run("feas", a_p, b_p)
    n = count()
    assert n == 1
    res = [second._run("feas", a_p, b_p), brk.call("feas", a_p, b_p)]
    assert count() == n
    ref = first._run("feas", a_p, b_p)
    for r in res:
        assert_equal(r, ref)


def test_cpu_default_is_eager_and_graph_true_raises(eager):
    """(f) On the CPU the default route is eager (a plan adds no graph);
    asking for a graph there raises."""
    for make in (lambda g: tplanner.BoundPlanner(**KW, device="cpu", graph=g),
                 lambda g: BatchBroker(device="cpu", graph=g),
                 lambda g: PhaseSyncBroker(device="cpu", graph=g)):
        with pytest.raises(ValueError, match="CUDA"):
            make(True)
        assert make(None).graph is False and make(False).graph is False
    planner = tplanner.BoundPlanner(**KW, device="cpu", dtype=torch.float64)
    n = len(tplanner.graph_stats())
    planner._run("feas", *eager[2]["feas"][1][0])
    assert len(tplanner.graph_stats()) == n
