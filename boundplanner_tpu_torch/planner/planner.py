"""Global convex-set path planner (port of
``boundplanner_tpu/planner/planner.py``).

Re-design of `bound_planner/BoundPlanner/BoundPlanner.py:26-896`: the
irregular parts (growing a roadmap of convex sets, shortest path over set
intersections, rejection sampling) stay host-side numpy orchestration,
while every numeric leaf runs as batched torch on the planner's device
and dtype (numpy in, numpy out, as in the JAX package):

- set growth              -> `set_finder.find_set_around_point` / `find_set_line`
- intersection testing    -> `ops.qp.solve_feasibility` (replaces HiGHS linprog)
- EE-fit probing          -> `via_opt.fit_ee_in_set` (20 rotation samples as
                             one batch; replaces 20 sequential qpOASES solves)
- edge-cost projections   -> `ops.qp.solve_projection`
- via-point rotation NLP  -> `via_opt.solve_via_rot` (replaces Ipopt)
- H-rep redundancy removal-> `utils.sets.reduce_ineqs` (native geom core /
                             numpy; replaces cddlib)

The host graph itself is this package's own model (`roadmap.SetRoadmap`:
dataclasses + union-find + heapq Dijkstra) rather than the reference's
networkx pair-of-graphs with lazily propagated connectivity flags.

Fidelity notes: the reference always ends up calling its around-point set
search with ``fixed_mid`` truthy due to a tuple bug (`BoundPlanner.py:494`
creates a non-empty tuple); we use ``fixed_mid=True`` for sampled seeds,
which is the de-facto reference behavior. The replanning backward-extension
LP (`BoundPlanner.py:713-718`) is one-dimensional and solved in closed
form. Junction anchors are always goal-projected at creation (the
reference computes them lazily from the first neighbor processed);
connectivity is exact reachability (union-find) instead of the reference's
pairwise flag propagation, which can under-report connectivity and force
extra sampling rounds. See DEVIATIONS.md.
"""

from __future__ import annotations

import copy
import functools
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
from scipy.spatial.transform import Rotation as SciRotation

from ..config import PlannerParams, MPC_SET_ROWS
from ..mpc import graph as graph_mod
from ..ops.mvie import mvie
from ..ops.qp import solve_feasibility, solve_projection
from ..utils.device import DEFAULT_DEVICE, checked_device, graph_route
from ..utils.sets import make_box, box_vertices, normalize_set_size, reduce_ineqs
from ..utils.tree import to_numpy, to_torch, tree_map
from .roadmap import Junction, PlanningError, SafeSet, SetRoadmap
from .set_finder import build_obstacle_arrays, find_set_around_point, find_set_line
from .via_opt import fit_ee_in_set, solve_via_rot

FIT_ROWS = 48  # padded row count for intersection-set device problems
SPATH_PAD = 64  # padded junction count for the batched shortest path ("spath")


def _find_set_line_ws(p0, p1, obs, ws_min, ws_max, n_rows):
    """`find_set_line` inside the workspace box (the planner's setting)."""
    return find_set_line(p0, p1, obs, 0.0, ws_min, ws_max, limit_space=False, n_rows=n_rows)


@functools.lru_cache(maxsize=None)
def via_rot_kernel(nr_via: int):
    """The via-rotation NLP of ``nr_via`` vias (one function per count, so
    every planner and broker of the process shares its graphs)."""
    return functools.partial(solve_via_rot, nr_via=nr_via)


@functools.lru_cache(maxsize=None)
def _kernel_table(max_set_size: int, max_via: int):
    kernels = {
        "fsap": functools.partial(find_set_around_point, fixed_mid=False, n_rows=max_set_size),
        "fsap_mid": functools.partial(find_set_around_point, fixed_mid=True, n_rows=max_set_size),
        "fsl": functools.partial(_find_set_line_ws, n_rows=max_set_size),
        "mvie": mvie,
        "feas": solve_feasibility,
        "fit_ee": fit_ee_in_set,
        "proj": solve_projection,
    }
    for k in range(1, max_via + 1):
        kernels[f"via_rot_{k}"] = via_rot_kernel(k)
    return kernels


def planner_kernels(max_set_size: int, max_via: int = 6):
    """The batch-major functions behind the planner's device-kernel keys
    (the broker registers the same ones): set growth, MVIE, intersection
    feasibility, EE-fit probing, point projection, and the via-rotation NLP
    of each via count 1..max_via. The functions are built once per
    (max_set_size, max_via); the dict is the caller's own."""
    return dict(_kernel_table(max_set_size, max_via))


# the process's planner graphs, as JAX's jit cache: one per (kernel key,
# the function and its static arguments, input signature), shared by
# every BoundPlanner and broker
_GRAPHS: dict = {}
_GRAPHS_LOCK = threading.Lock()


def _static_key(fn):
    """A function with its static arguments: a ``functools.partial`` by
    value (its function, arguments and keywords), anything else by
    identity."""
    if isinstance(fn, functools.partial):
        return fn.func, fn.args, tuple(sorted(fn.keywords.items()))
    return fn


def device_call(key: str, fn, inputs, graph: bool):
    """``fn(*inputs)`` (trees of tensors, a leading batch axis): eagerly,
    or replayed from the process's graph of (``key``, ``fn`` and its static
    arguments, the inputs' signature) when ``graph`` is set
    (`mpc.graph.Graph`: its first call runs eagerly and captures)."""
    if not graph:
        return fn(*inputs)
    cache_key = (key, _static_key(fn), graph_mod.signature(inputs))
    with _GRAPHS_LOCK:
        runner = _GRAPHS.get(cache_key)
        if runner is None:
            runner = _GRAPHS[cache_key] = graph_mod.Graph(fn, inputs)
    return runner(*inputs)


def graph_stats() -> list:
    """``stats()`` of each of the process's planner graphs, with its kernel
    key."""
    with _GRAPHS_LOCK:
        items = list(_GRAPHS.items())
    return [{"key": k[0], **runner.stats()} for k, runner in items]


def _pad(a, b, rows):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    m = a.shape[0]
    if m > rows:
        # keep the tightest rows (smallest b after normalization); reference
        # would print an error (`util_functions.py:130-132`)
        order = np.argsort(b)[:rows]
        a, b, m = a[order], b[order], rows
    a_p = np.zeros((rows, 3))
    b_p = 10.0 * np.ones(rows)
    a_p[:m] = a
    b_p[:m] = b
    return a_p, b_p


def _strip(a, b, tol=9.0):
    """Remove inactive padded rows."""
    a = np.asarray(a)
    b = np.asarray(b)
    keep = (b < tol) & (np.linalg.norm(a, axis=1) > 1e-8)
    return a[keep], b[keep]


def _rodrigues_np(axis, angle):
    return SciRotation.from_rotvec(np.asarray(axis) * angle).as_matrix()


class BoundPlanner:
    def __init__(
        self,
        obstacles: Sequence[Sequence[float]] = (),
        e_p_max: float = 0.5,
        obs_size_increase: float = 0.08,
        workspace_max=(1.0, 1.0, 1.2),
        workspace_min=(-1.0, -1.0, 0.0),
        seed: Optional[int] = None,
        verbose: bool = False,
        broker=None,
        device=DEFAULT_DEVICE,
        dtype=torch.float32,
        graph: bool | None = None,
    ):
        # optional `parallel.broker.BatchBroker`: when set, the device-kernel
        # wrappers below coalesce with other scenes' planners into shared
        # batched calls (see `parallel.broker.register_planner_kernels`)
        self.broker = broker
        # where and in which precision the numeric leaves run: float32
        # mirrors the JAX package with x64 off, float64 with x64 on
        self.device = checked_device(device)
        self.dtype = dtype
        # the route of the direct device calls on the card (`device_call`)
        self.graph = graph_route(graph, self.device)
        self.params = PlannerParams(
            e_p_max=e_p_max,
            obs_size_increase=obs_size_increase,
            workspace_max=tuple(workspace_max),
            workspace_min=tuple(workspace_min),
        )
        self.verbose = verbose
        self.rng = np.random.default_rng(seed)
        self.max_set_size = self.params.max_set_size
        self._kernels = planner_kernels(self.max_set_size)
        self.ws_min = np.asarray(workspace_min, dtype=np.float64)
        self.ws_max = np.asarray(workspace_max, dtype=np.float64)
        self.sets_via_prev: List = []
        self.replanning = False
        self.replanning_phi = 0.0

        # timing accumulators (ref `BoundPlanner.py:40-46`)
        self.comp_time_set = 0.0
        self.comp_time_edge = 0.0
        self.comp_time_fit = 0.0
        self.comp_time_graph = 0.0
        self.comp_time_path = 0.0
        self.comp_time_via = 0.0
        self.comp_time_total = 0.0

        self.obstacles: List[List[float]] = []
        self.obs_sets: List = []          # expanded, padded [A,b]
        self.obs_sets_orig: List = []
        self.obs_points_sets: List[np.ndarray] = []
        self.add_obstacle_reps(obstacles)

    # ------------------------------------------------------------------
    def _log(self, *args):
        if self.verbose:
            print(*args)

    def add_obstacle_reps(self, obstacles, update=False, reset=False):
        """(ref `BoundPlanner.py:131-152`)."""
        if reset:
            self.obstacles = []
            self.obs_sets = []
            self.obs_sets_orig = []
            self.obs_points_sets = []
        inc = self.params.obs_size_increase
        for ob in obstacles:
            self.obstacles.append(list(ob))
            lb, ub = np.asarray(ob[:3], float), np.asarray(ob[3:], float)
            a, b = make_box(lb, ub)
            self.obs_sets_orig.append([a, b])
            self.obs_sets.append(list(_pad(a, b + inc, MPC_SET_ROWS)))
            self.obs_points_sets.append(box_vertices(lb - inc, ub + inc))
        self.obs_arrays = build_obstacle_arrays(self.obstacles, inc)

    # ------------------------------------------------------------------
    # device-kernel wrappers (numpy in / numpy out)

    def _run(self, key, *args):
        """One device-kernel call: through the broker when it serves ``key``
        (coalesced with other planners' calls), else as a batch of one on
        (device, dtype), through the key's graph on the card unless
        ``graph`` is False. Returns this call's results as numpy."""
        if self.broker is not None and key in self.broker._fns:
            return self.broker.call(key, *args)
        batch = to_torch(tree_map(lambda a: np.asarray(a)[None], args), self.device, self.dtype)
        out = device_call(key, self._kernels[key], batch, self.graph)
        return tree_map(lambda a: a[0], to_numpy(out))

    def _find_set_around_point(self, p_seed, fixed_mid=False):
        a, b, shape, center, ok = self._run(
            "fsap_mid" if fixed_mid else "fsap",
            np.asarray(p_seed, float), self.obs_arrays, self.ws_min, self.ws_max,
        )
        return a, b, shape, center, bool(ok)

    def _find_set_line(self, p0, p1, compute_ellipsoid=False):
        a, b, coll = self._run(
            "fsl", np.asarray(p0, float), np.asarray(p1, float),
            self.obs_arrays, self.ws_min, self.ws_max,
        )
        if compute_ellipsoid:
            res = self._run("mvie", a, b)
            return a, b, res.shape, res.center, bool(coll)
        return a, b, bool(coll)

    def _intersection_point(self, set1, set2, tol=0.0):
        """Feasible point of the intersection, or None when empty
        (ref `BoundPlanner.py:774-787`, scipy linprog replaced by the
        device phase-1 QP)."""
        a = np.concatenate([set1[0], set2[0]])
        b = np.concatenate([set1[1], set2[1]])
        a_p, b_p = _pad(a, b - tol, FIT_ROWS)
        x, t, _ = self._run("feas", a_p, b_p)
        if not bool(t < 1e-7):
            return None, (a, b)
        return x, (a, b)

    def _ee_fit(self, a_set, b_set, probe_point):
        """Does the EE segment fit in the set at one of 20 sampled rotation
        fractions? Returns (fits, via seed [p, omega])
        (ref `BoundPlanner.py:745-772`)."""
        a_p, b_p = _pad(a_set, b_set - 0.001, FIT_ROWS)
        fits, omega, p_in = self._run(
            "fit_ee", a_p, b_p, np.asarray(self.l_ee, float),
            np.asarray(self.omega_normed, float), np.asarray(self.omega_norm, float),
            np.asarray(probe_point, float),
        )
        # seed at the fit QP's feasible point when it found one (the
        # reference requests but discards it, `BoundPlanner.py:758-766`)
        p_seed = p_in if bool(fits) else np.asarray(probe_point, float)
        return bool(fits), np.concatenate((p_seed, [float(omega)]))

    def _project_into(self, a, b, target):
        a_p, b_p = _pad(a, b, FIT_ROWS)
        sol = self._run("proj", a_p, b_p, np.asarray(target, float))
        return sol.x

    def _shortest_path(self, roadmap: SetRoadmap):
        """Junction path start -> end: the host Dijkstra, or the batched
        min-plus search (`planner.device_search`) when the broker serves
        the "spath" key and the roadmap fits ``SPATH_PAD`` junctions, so
        concurrent planners coalesce their searches into one call. The
        search relaxes in float32 whatever the planner's dtype: on
        near-ties it may pick another path than the float64 Dijkstra."""
        n = len(roadmap.junctions)
        if self.broker is not None and "spath" in self.broker._fns and n <= SPATH_PAD:
            from .device_search import roadmap_adjacency

            _, path, reached = self.broker.call("spath", roadmap_adjacency(roadmap, SPATH_PAD))
            if not bool(reached):
                raise PlanningError("roadmap: start and end not connected")
            return [int(x) for x in path if x >= 0]
        return roadmap.shortest_path()

    # ------------------------------------------------------------------
    # roadmap construction

    def _insert_set(self, roadmap: SetRoadmap, sid: int, goal) -> None:
        """Create junctions between set ``sid`` and every other set whose
        intersection is nonempty (replaces `add_edges`,
        `BoundPlanner.py:789-896`; edge linking and costs live in
        `SetRoadmap.add_junction`)."""
        new = roadmap.sets[sid]
        for other_id in range(len(roadmap.sets)):
            if other_id == sid:
                continue
            other = roadmap.sets[other_id]
            probe, (a_j, b_j) = self._intersection_point(
                (other.a, other.b), (new.a, new.b), tol=0.01
            )
            if probe is None:
                continue
            t0 = time.perf_counter()
            fits, via = self._ee_fit(a_j, b_j, probe)
            self.comp_time_fit += time.perf_counter() - t0
            anchor = self._project_into(a_j, b_j, goal)
            roadmap.add_junction(
                Junction(
                    a=a_j, b=b_j, owners=(other_id, sid),
                    anchor=anchor, via=via, fits=fits,
                )
            )

    def _grown_safe_set(self, a_set, b_set, ellipsoid, mid) -> SafeSet:
        a_np, b_np = reduce_ineqs(*_strip(a_set, b_set))
        return SafeSet(
            a=a_np, b=b_np,
            volume=float(np.linalg.det(ellipsoid)),
            ellipsoid=np.asarray(ellipsoid), mid=np.asarray(mid),
        )

    # ------------------------------------------------------------------
    def _via_points_for(
        self, roadmap, path, start, end, with_rot=False
    ):
        """Via points along a junction path (replaces `compute_via_points`,
        `BoundPlanner.py:586-743`)."""
        interior = path[1:-1]
        nr_via = len(interior)

        # junction sets (shrunk 1 mm on active rows) + initial guess
        sets_inter = []
        x0 = np.empty(0)
        for jid in interior:
            jct = roadmap.junctions[jid]
            a = jct.a.copy()
            b = jct.b.copy()
            b[np.linalg.norm(a, axis=1) > 1e-4] -= 0.001
            sets_inter.append([a, b])
            x0 = np.concatenate((x0, jct.anchor, [0.5]))

        # active safe set per path element; element i covers segment i
        # (same walk as the reference, `BoundPlanner.py:607-637`)
        current = roadmap.junctions[path[0]].owners[0]
        active = [current]
        for jid in path[1:]:
            o0, o1 = roadmap.junctions[jid].owners
            nxt = o0 if o0 != current else o1
            if nxt != current:
                current = nxt
            active.append(current)
        chain = [s for i, s in enumerate(active) if i == 0 or s != active[i - 1]]
        seg_sets = [
            [roadmap.sets[s].a, roadmap.sets[s].b] for s in active
        ]
        w_size_via = 1 - np.cbrt(
            np.asarray([roadmap.sets[s].volume for s in chain], dtype=float)
        )

        sol_x = None
        # The rotation NLP packs exactly nr_via+1 via sets / size weights
        # (the reference's fixed parameter layout assumes the same,
        # `BoundPlanner.py:651-667`). Rare graph paths produce an extra
        # set change at the terminal node; fall back to projection-based
        # via points there instead of mis-packing (the reference would
        # silently corrupt its parameter vector).
        if len(chain) != nr_via + 1:
            self._log(
                f"(PosOpt) irregular set chain ({len(chain)} sets for "
                f"{nr_via} intersections); skipping rot NLP"
            )
            with_rot = False
        if with_rot and nr_via > 0:
            a_i = np.stack([_pad(s[0], s[1], FIT_ROWS)[0] for s in sets_inter])
            b_i = np.stack([_pad(s[0], s[1], FIT_ROWS)[1] for s in sets_inter])
            a_v = np.stack(
                [_pad(s[0], s[1], FIT_ROWS)[0] for s in seg_sets[: nr_via + 1]]
            )
            b_v = np.stack(
                [_pad(s[0], s[1], FIT_ROWS)[1] for s in seg_sets[: nr_via + 1]]
            )
            via_key = f"via_rot_{nr_via}"
            self._kernels.setdefault(via_key, via_rot_kernel(nr_via))
            res = self._run(
                via_key, x0, np.asarray(start, float), np.asarray(end, float),
                np.asarray(self.l_ee, float), np.asarray(self.omega_normed, float),
                np.asarray(self.omega_norm, float), np.asarray(w_size_via, float),
                a_i, b_i, a_v, b_v,
            )
            if not bool(res.success):
                self._log(
                    f"(PosOpt) ERROR No convergence in via point rot optimization "
                    f"(viol {float(res.viol):.2e})"
                )
            else:
                self._log("(PosOpt) Found via point path with rot through graph")
            sol_x = np.asarray(res.x)

        # assemble the via sequence, dropping duplicate points
        sets_via = []
        p_via = [np.asarray(start, float)]
        omega_via = [0.0]
        packed = sol_x if sol_x is not None else x0
        for i in range(nr_via):
            cand = packed[4 * i : 4 * (i + 1)]
            if np.linalg.norm(cand[:3] - p_via[-1]) > 1e-4:
                p_via.append(cand[:3])
                omega_via.append(float(cand[3]))
                sets_via.append(seg_sets[i])
            if self.replanning and i == 0 and len(p_via) > 1:
                self._extend_first_segment_backward(p_via, sets_via)
        p_via.append(np.asarray(end, float))
        omega_via.append(1.0)
        sets_via.append(seg_sets[-1])
        return np.array(p_via), p_via, omega_via, sets_via

    def _extend_first_segment_backward(self, p_via, sets_via):
        """Replanning: pull the first via backwards along the first segment
        so phi stays continuous with the committed horizon. The reference
        solves a 1-D LP (`BoundPlanner.py:706-729`); in one dimension the
        optimum is closed-form."""
        a0 = np.asarray(sets_via[0][0])
        b0 = np.asarray(sets_via[0][1])
        b_trans0 = b0 - a0 @ p_via[0]
        dp0 = p_via[1] - p_via[0]
        dp0 = dp0 / np.linalg.norm(dp0)
        dp_horizon = np.asarray(self.p_horizon) - p_via[0]
        # min phi s.t. a0 (phi dp0) <= b_trans0 — 1-D closed form
        coef = a0 @ dp0
        neg = coef < -1e-12
        phi_lp = np.max(b_trans0[neg] / coef[neg]) if np.any(neg) else -np.inf
        phi_horizon = float(np.min(dp0 @ dp_horizon.T))
        phi_horizon = min(phi_horizon, -0.5)
        self.replanning_phi = max(-phi_horizon, 0.0)
        self._log(f"(Replanning) Horizon phi: {phi_horizon:.3f}")
        self._log(f"(Replanning) Linprog phi: {phi_lp:.3f}")
        if phi_horizon < phi_lp:
            self._log("(Replanning) Horizon needs deviations")
        p_via[0] = p_via[0] - self.replanning_phi * dp0

    # ------------------------------------------------------------------
    # plan phases

    def _prepare_rotation(self, r0, r1):
        """Rotation interpolation setup (ref `BoundPlanner.py:207-219`)."""
        par = self.params
        self.omega = SciRotation.from_matrix(r1 @ np.asarray(r0).T).as_rotvec()
        self.omega_norm = float(np.linalg.norm(self.omega))
        if self.omega_norm > 1e-6:
            self.omega_normed = self.omega / self.omega_norm
        else:
            self.omega_normed = np.array([0.0, 0.0, 1.0])
        self.l_ee = np.asarray(r0) @ np.array([-par.length_ee, 0, 0])
        self.l_ee_end = np.asarray(r1) @ np.array([-par.length_ee, 0, 0])

    def _push_point_free(self, p, which="end"):
        """Project a point out of any obstacle it violates
        (ref `BoundPlanner.py:199-204`)."""
        par = self.params
        for ob in self.obs_sets:
            a_ob, b_ob = _strip(ob[0], ob[1])
            viol = a_ob @ p - b_ob
            if not np.any(viol > 0):
                self._log(
                    f"(PosPath) Projecting {which} point to collision free space"
                )
                idx = int(np.argmax(viol))
                p = p - (viol[idx] - par.obs_size_increase) * a_ob[idx]
        return p

    def _grow_start_set(self, start, new_obs):
        """Start set: around-point normally; along the committed horizon
        when replanning (ref `BoundPlanner.py:229-325`)."""
        collision = False
        if self.replanning and self.sets_via_prev:
            horizon = np.asarray(self.p_horizon)
            max_h = 1
            for s in self.sets_via_prev:
                a_s, b_s = np.asarray(s[0]), np.asarray(s[1])
                start_in = np.max(a_s @ start - b_s) < 1e-8
                if horizon.size:
                    h_in = np.max(a_s @ horizon.T - b_s[:, None], axis=0) < 1e-8
                    h_out = np.where(~h_in)[0]
                    if start_in and h_out.size and h_out[0] > 0:
                        max_h = max(max_h, h_out[0] - 1)
                    elif start_in and not h_out.size:
                        max_h = len(self.p_horizon) - 1
                        break
            if new_obs:
                max_h = 1
            self.p_horizon_max = self.p_horizon[max_h] if self.p_horizon else start
            a_set, b_set, q_ell, p_mid, collision = self._find_set_line(
                start, self.p_horizon_max, compute_ellipsoid=True
            )
        else:
            a_set, b_set, q_ell, p_mid, _ = self._find_set_around_point(
                start, fixed_mid=True
            )
            a_s, b_s = _strip(a_set, b_set)
            if np.max(a_s @ (start + self.l_ee) - b_s) > 1e-8:
                a_set, b_set, q_ell, p_mid, collision = self._find_set_line(
                    start, start + self.l_ee, compute_ellipsoid=True
                )
        if collision and self.sets_via_prev:
            self._log("[WARNING] Could not find start set, reusing old end set")
            a_set = copy.deepcopy(np.asarray(self.sets_via_prev[-1][0]))
            b_set = copy.deepcopy(np.asarray(self.sets_via_prev[-1][1]))
            p_mid = start
            q_ell = np.eye(3)
        return a_set, b_set, q_ell, p_mid

    def _sample_free_point(self, roadmap):
        """Rejection-sample a workspace point outside every obstacle and
        outside every known safe set (ref `BoundPlanner.py:448-483`)."""
        par = self.params
        for _ in range(par.max_samples):
            sample = self.rng.uniform(par.workspace_min, par.workspace_max, 3)
            in_collision = any(
                np.max(_strip(ob[0], ob[1])[0] @ sample - _strip(ob[0], ob[1])[1])
                < 1e-3
                for ob in self.obs_sets
            )
            if in_collision:
                continue
            in_safe = any(
                np.max(s.a @ sample - s.b) < 1e-3 for s in roadmap.sets
            )
            if not in_safe:
                return sample
        raise PlanningError("(PosPath) Could not find collision-free sample")

    # ------------------------------------------------------------------
    def plan_convex_set_path(
        self,
        start,
        end,
        r0,
        r1,
        replanning=False,
        p_horizon=(),
        first_sample=None,
        new_obs=False,
    ):
        """(ref `BoundPlanner.py:174-584`)."""
        par = self.params
        start = np.asarray(start, float).copy()
        end = np.asarray(end, float).copy()
        t_total0 = time.perf_counter()
        self.replanning = replanning
        self.replanning_phi = 0.0
        self.p_horizon = list(p_horizon)

        end = self._push_point_free(end)
        if not replanning:
            # Round-5 soundness fix (EXCEEDS the reference, which pushes
            # only the END point free for fresh plans, `BoundPlanner.py:199-204`,
            # and the start only when replanning, `:296-318`): a start set
            # grown from a seed INSIDE an obstacle cannot be separated
            # from that obstacle — the measured result was segment-0 sets
            # overlapping a box by 3-5 cm on fleet scenes whose sampled
            # boxes land on the start EE, i.e. a corridor the MPC
            # faithfully tracks THROUGH the box (ROUND5_NOTES). Growing
            # from the projected-free start makes the corridor sound; the
            # robot starts slightly outside segment 0 (phi < 0, slack
            # absorbs the initial set violation) and tracking pulls it
            # out of the box and into the corridor. No-op for collision-
            # free starts (bit-identical plans).
            start = self._push_point_free(start, which="start")
        self._prepare_rotation(r0, r1)

        roadmap = SetRoadmap(
            w_size=par.w_size, w_bias=par.w_bias, c_fit=par.c_fit
        )
        self.roadmap = roadmap

        # --- start set + its pseudo-junction (id 0) ---
        t0 = time.perf_counter()
        start_set = self._grown_safe_set(*self._grow_start_set(start, new_obs))
        self.comp_time_set += time.perf_counter() - t0
        sid0 = roadmap.add_set(start_set)
        roadmap.add_junction(
            Junction(
                a=start_set.a, b=start_set.b, owners=(sid0, sid0),
                anchor=start, via=np.concatenate((start, [0.0])), fits=True,
            )
        )
        t0 = time.perf_counter()
        self._insert_set(roadmap, sid0, end)
        self.comp_time_edge += time.perf_counter() - t0

        # end point already inside the start set? (ref `:361-375`)
        if (
            np.max(start_set.a @ end - start_set.b) < 1e-8
            and np.max(start_set.a @ (end + self.l_ee_end) - start_set.b) < 1e-8
        ):
            self._log("(PosPath) End point in start set, finishing ...")
            omega_via = [0.0, 1.0]
            r_via = [
                _rodrigues_np(self.omega_normed, self.omega_norm * x) @ np.asarray(r0)
                for x in omega_via
            ]
            sets_via = normalize_set_size(
                [[start_set.a, start_set.b]], MPC_SET_ROWS
            )
            self.sets_via_prev = copy.deepcopy(sets_via)
            return [start, end], r_via, [np.array([0.0, 0.0, 1.0])], sets_via

        # --- end set + its pseudo-junction (id 1) ---
        t0 = time.perf_counter()
        a_e, b_e, q_e, mid_e, _ = self._find_set_line(
            end, end + self.l_ee_end, compute_ellipsoid=True
        )
        end_set = self._grown_safe_set(a_e, b_e, q_e, mid_e)
        self.comp_time_set += time.perf_counter() - t0
        sid1 = roadmap.add_set(end_set)
        roadmap.add_junction(
            Junction(
                a=end_set.a, b=end_set.b, owners=(sid1, sid1),
                anchor=end, via=np.concatenate((end, [1.0])), fits=True,
            )
        )
        t0 = time.perf_counter()
        self._insert_set(roadmap, sid1, end)
        self.comp_time_edge += time.perf_counter() - t0

        # --- grow the roadmap until the via points converge (ref `:426-534`) ---
        t_graph0 = time.perf_counter()
        used_first_sample = False
        nr_rounds = 0
        p_via_old = None
        path = None
        while True:
            if roadmap.connected():
                t0 = time.perf_counter()
                path = self._shortest_path(roadmap)
                self.comp_time_path += time.perf_counter() - t0
                t0 = time.perf_counter()
                p_via, p_via_list, omega_via, sets_via = self._via_points_for(
                    roadmap, path, start, end
                )
                self.comp_time_via += time.perf_counter() - t0
                if (
                    p_via_old is not None
                    and p_via_old.shape == p_via.shape
                    and np.linalg.norm(p_via_old - p_via) < 1e-4
                ):
                    self._log("(PosPath) Found path solution")
                    break
                p_via_old = np.copy(p_via)
                seeds = p_via_list[1:-1]
            elif not used_first_sample and first_sample is not None:
                seeds = [np.asarray(first_sample, float)]
            else:
                seeds = [self._sample_free_point(roadmap)]
                self._log(f"(PosPath) Adding random point {seeds[0]} to graph")
                nr_rounds += 1
                if nr_rounds > par.max_iters:
                    raise PlanningError("(PosPath) Exceeded max iterations")

            for seed in seeds:
                t0 = time.perf_counter()
                a_s, b_s, shape, mid, _ = self._find_set_around_point(
                    np.asarray(seed, float), fixed_mid=True
                )
                cand = self._grown_safe_set(a_s, b_s, shape, mid)
                used_first_sample = True
                self.comp_time_set += time.perf_counter() - t0
                # skip sets indistinguishable from known ones (ref `:497-510`)
                dmin = min(
                    (
                        np.linalg.norm(cand.ellipsoid - s.ellipsoid)
                        + np.linalg.norm(cand.mid - s.mid)
                        for s in roadmap.sets
                    ),
                    default=np.inf,
                )
                if dmin > 0.01:
                    sid = roadmap.add_set(cand)
                    t0 = time.perf_counter()
                    self._insert_set(roadmap, sid, end)
                    self.comp_time_edge += time.perf_counter() - t0
                else:
                    self._log(
                        f"(PosPath) Set already known, min distance {dmin:.3f}"
                    )
        self.comp_time_graph = time.perf_counter() - t_graph0
        self.nr_sets = len(roadmap.sets)

        # --- final via path with rotation (ref `:538-584`) ---
        t0 = time.perf_counter()
        p_via, p_via_list, omega_via, sets_via = self._via_points_for(
            roadmap, path, start, end, with_rot=True
        )
        self.sets_via_prev = copy.deepcopy(sets_via)
        self.comp_time_via += time.perf_counter() - t0

        bp1_list = [self._first_basis(p_via[i + 1] - p_via[i]) for i in range(len(p_via) - 1)]
        r_via = [
            _rodrigues_np(self.omega_normed, self.omega_norm * x) @ np.asarray(r0)
            for x in omega_via
        ]
        r_via[0] = (
            _rodrigues_np(self.omega_normed, -self.replanning_phi * self.omega_norm)
            @ np.asarray(r0)
        ) if self.omega_norm > 1e-9 else np.asarray(r0)

        sets_via_normed = normalize_set_size(sets_via, MPC_SET_ROWS)
        self.comp_time_total = time.perf_counter() - t_total0
        if self.verbose:
            self.print_computation_time()
        return p_via_list, r_via, bp1_list, sets_via_normed

    @staticmethod
    def _first_basis(dp):
        """Unit basis vector orthogonal to the segment direction, preferring
        world-z (ref `BoundPlanner.py:559-570`)."""
        dp = dp / np.linalg.norm(dp)
        b1 = np.array([0.0, 0.0, 1.0])
        b1 = b1 - np.dot(dp, b1) * dp
        n1 = np.linalg.norm(b1)
        if n1 < 1e-3:
            b1 = np.array([1.0, 1.0, 1.0])
            b1 = b1 - np.dot(dp, b1) * dp
            n1 = np.linalg.norm(b1)
        return b1 / n1

    def print_computation_time(self):
        """(ref `BoundPlanner.py:154-172`)."""
        print(f"(PosPath) Computed {self.nr_sets} sets")
        print(f"(PosPath) Building graph of convex sets: {self.comp_time_graph:.4f}s")
        print(f"(PosPath) -> Shortest path: {self.comp_time_path:.4f}s")
        print(f"(PosPath) -> Via point optimization: {self.comp_time_via:.4f}s")
        print(f"(PosPath) -> Set computation: {self.comp_time_set:.4f}s")
        print(f"(PosPath) -> Edge computation: {self.comp_time_edge:.4f}s")
        print(f"(PosPath) --> Fit computation: {self.comp_time_fit:.4f}s")
        print(f"(PosPath) Total time: {self.comp_time_total:.4f}s")
