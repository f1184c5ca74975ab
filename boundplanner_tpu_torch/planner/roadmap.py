"""Roadmap of convex safe sets and their pairwise intersections.
A copy of ``boundplanner_tpu/planner/roadmap.py`` (host numpy), whose
package import would load jax.

Own data model for the planner's host-side graph (re-design of the
networkx graphs in `bound_planner/BoundPlanner/BoundPlanner.py:789-896`):

- ``SafeSet``   — one collision-free polytope with its inscribed-ellipsoid
  volume proxy and midpoint.
- ``Junction``  — a nonempty pairwise intersection of two safe sets (or a
  start/end pseudo-junction). Path search runs over junctions; two
  junctions are adjacent iff they share an owner set, and traversing that
  edge means crossing the shared set.
- ``SetRoadmap`` — owns both, maintains the adjacency with the reference's
  edge-cost model, answers connectivity by union-find (exact, where the
  reference propagates conn_to_start/conn_to_end flags pairwise — a lazy
  under-approximation of reachability; deviation documented in
  DEVIATIONS.md), and runs Dijkstra with a binary heap.

Junction 0 is the start pseudo-junction, junction 1 the end one.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


class PlanningError(RuntimeError):
    """The planner found no path (a planning outcome, not a device fault)."""


@dataclass
class SafeSet:
    a: np.ndarray               # (m, 3) half-space rows
    b: np.ndarray               # (m,)
    volume: float               # det of the inscribed ellipsoid shape
    ellipsoid: np.ndarray       # (3, 3)
    mid: np.ndarray             # (3,)


@dataclass
class Junction:
    a: np.ndarray               # stacked rows of both owners
    b: np.ndarray
    owners: Tuple[int, int]     # SafeSet ids; equal for pseudo-junctions
    anchor: np.ndarray          # goal-ward representative point
    via: np.ndarray             # (4,) via seed [p, omega]
    fits: bool                  # EE fits at some sampled rotation


class _UnionFind:
    def __init__(self):
        self._parent: List[int] = []

    def add(self) -> int:
        self._parent.append(len(self._parent))
        return len(self._parent) - 1

    def find(self, i: int) -> int:
        root = i
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[i] != root:  # path compression
            self._parent[i], i = root, self._parent[i]
        return root

    def union(self, i: int, j: int):
        self._parent[self.find(i)] = self.find(j)


@dataclass
class SetRoadmap:
    """Cost model knobs mirror `config.PlannerParams` (numerically equal to
    the reference's edge cost, `BoundPlanner.py:877-884`)."""

    w_size: float
    w_bias: float
    c_fit: float

    sets: List[SafeSet] = field(default_factory=list)
    junctions: List[Junction] = field(default_factory=list)
    _adj: List[Dict[int, float]] = field(default_factory=list)
    _by_owner: Dict[int, List[int]] = field(default_factory=dict)
    _uf: _UnionFind = field(default_factory=_UnionFind)

    # ------------------------------------------------------------------
    def add_set(self, s: SafeSet) -> int:
        self.sets.append(s)
        return len(self.sets) - 1

    def add_junction(self, j: Junction) -> int:
        """Insert a junction and link it to every junction sharing an
        owner set. Returns the junction id."""
        jid = len(self.junctions)
        self.junctions.append(j)
        self._adj.append({})
        self._uf.add()

        siblings = set()
        for owner in set(j.owners):
            siblings.update(self._by_owner.get(owner, ()))
            self._by_owner.setdefault(owner, []).append(jid)

        for other_id in siblings:
            other = self.junctions[other_id]
            shared = self._shared_owner(j, other)
            if shared is None:
                continue
            w = self._edge_cost(j, other, shared)
            self._adj[jid][other_id] = w
            self._adj[other_id][jid] = w
            self._uf.union(jid, other_id)
        return jid

    @staticmethod
    def _shared_owner(a: Junction, b: Junction) -> Optional[int]:
        # prefer the older (smaller-id) shared set, matching the
        # reference's cond1-first branch (`BoundPlanner.py:866-870`)
        common = sorted(set(a.owners) & set(b.owners))
        return common[0] if common else None

    def _edge_cost(self, j: Junction, other: Junction, shared: int) -> float:
        """dist * (1 + w_size * tanh(0.25 - cbrt(volume))) + w_bias
        (+ c_fit when the EE does not fit in the new junction) —
        numerically the reference's cost (`BoundPlanner.py:877-884`)."""
        dist = float(np.linalg.norm(j.anchor - other.anchor))
        size_term = np.tanh(0.25 - np.cbrt(max(self.sets[shared].volume, 0.0)))
        cost = dist * (1.0 + self.w_size * size_term) + self.w_bias
        if not j.fits:
            cost += self.c_fit
        return cost

    # ------------------------------------------------------------------
    def connected(self, a: int = 0, b: int = 1) -> bool:
        if max(a, b) >= len(self.junctions):
            return False
        return self._uf.find(a) == self._uf.find(b)

    def shortest_path(self, src: int = 0, dst: int = 1) -> List[int]:
        """Dijkstra over junctions (replaces `nx.shortest_path`,
        `BoundPlanner.py:434`)."""
        n = len(self.junctions)
        dist = np.full(n, np.inf)
        prev = np.full(n, -1, dtype=int)
        dist[src] = 0.0
        heap = [(0.0, src)]
        while heap:
            d, u = heapq.heappop(heap)
            if d > dist[u]:
                continue
            if u == dst:
                break
            for v, w in self._adj[u].items():
                nd = d + w
                if nd < dist[v]:
                    dist[v] = nd
                    prev[v] = u
                    heapq.heappush(heap, (nd, v))
        if not np.isfinite(dist[dst]):
            raise PlanningError("roadmap: start and end not connected")
        path = [dst]
        while path[-1] != src:
            path.append(int(prev[path[-1]]))
        return path[::-1]
