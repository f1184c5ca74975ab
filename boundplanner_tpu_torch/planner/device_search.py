"""Batched shortest paths over padded roadmap adjacency on the device
(port of ``boundplanner_tpu/planner/device_search.py``).

A fleet of planners searches one roadmap per scene and iteration. With
the junction count padded to a fixed size, every scene's search becomes
one batched masked min-plus Bellman-Ford relaxation (n - 1 rounds of
(B, n, n) broadcasts) with predecessor tracking and a fixed-length
predecessor walk, instead of a host Dijkstra per scene.

The relaxation runs in float32 whatever the caller's dtype, as the JAX
kernel does (a float64 caller gets float32 costs), and keeps
``argmin``'s first-index rule for ties. Plain batched torch ops: the JAX
function is plain ``jnp``, not a Pallas kernel.

As in the JAX package, the planner routes its searches through a
broker's "spath" key (`parallel.broker.register_planner_kernels(...,
device_search=True)`), off by default: on the H100 one batched call for
128 roadmaps at ``n_pad`` 64 took 12.7-25.9 ms against 4.3-10.7 ms for
the 128 host Dijkstras (``chip_smoke.py``'s ``device_search`` phase), and
a search is a few milliseconds of a plan of seconds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, checked_device
from .roadmap import PlanningError

NO_EDGE = np.float32(1e18)


def shortest_path_device(adj, src: int = 0, dst: int = 1):
    """Single-source shortest paths on dense padded adjacency matrices.

    adj: (n, n) or (B, n, n); ``NO_EDGE`` where there is no edge (the
    diagonal is irrelevant). Returns (dist, path, reached) with the batch
    axes of ``adj``: ``dist`` the float32 cost of dst, ``path`` (n,)
    int32, the node sequence src..dst padded with -1 after dst (all -1
    when dst is not reached)."""
    single = adj.dim() == 2
    adj = (adj[None] if single else adj).to(torch.float32)
    bsz, n = adj.shape[0], adj.shape[-1]
    dev = adj.device
    idx = torch.arange(n, device=dev)
    dist = torch.full((bsz, n), float(NO_EDGE), dtype=torch.float32, device=dev)
    dist[:, src] = 0.0
    prev = torch.full((bsz, n), -1, dtype=torch.int64, device=dev)
    prev[:, src] = src
    for _ in range(n - 1):
        cand = dist[:, :, None] + adj                   # via-u costs (B, u, v)
        best_u = torch.argmin(cand, dim=1)              # first index on ties
        best = torch.gather(cand, 1, best_u[:, None])[:, 0]
        improved = best < dist * (1.0 - 1e-7) - 1e-12
        dist = torch.where(improved, best, dist)
        prev = torch.where(improved, best_u, prev)
    reached = dist[:, dst] < 0.5 * float(NO_EDGE)

    # walk the predecessors dst -> src, n fixed steps: rev = [dst, ..., src, -1, ...]
    cur = torch.full((bsz,), dst, dtype=torch.int64, device=dev)
    rev = []
    for _ in range(n):
        rev.append(cur)
        step = torch.gather(prev, 1, cur.clamp(min=0)[:, None])[:, 0]
        cur = torch.where((cur == src) | (cur < 0), torch.full_like(cur, -1), step)
    rev = torch.stack(rev, dim=1)
    length = (rev >= 0).sum(dim=1, keepdim=True)
    pos = (length - 1 - idx).clamp(0, n - 1)           # source slot of slot i
    path = torch.where(idx < length, torch.gather(rev, 1, pos), torch.full_like(rev, -1))
    path = torch.where(reached[:, None], path, torch.full_like(path, -1)).to(torch.int32)
    out = dist[:, dst], path, reached
    return tuple(t[0] for t in out) if single else out


def roadmap_adjacency(roadmap, n_pad: int, dtype=np.float32):
    """Dense padded adjacency of a `SetRoadmap` (numpy, host-side)."""
    n = len(roadmap.junctions)
    if n > n_pad:
        raise ValueError(f"{n} junctions exceed pad size {n_pad}")
    adj = np.full((n_pad, n_pad), NO_EDGE, dtype)
    for u, nbrs in enumerate(roadmap._adj):
        for v, w in nbrs.items():
            adj[u, v] = w
    return adj


def fleet_shortest_paths(roadmaps, n_pad: int = 64, device=DEFAULT_DEVICE):
    """One batched call for a whole fleet's roadmap searches on ``device``.

    Returns a list of node-id lists (like `SetRoadmap.shortest_path`);
    raises `PlanningError` for any unreached scene, as the host method
    does."""
    device = checked_device(device)
    adj = np.stack([roadmap_adjacency(r, n_pad) for r in roadmaps])
    _, paths, reached = shortest_path_device(torch.from_numpy(adj).to(device))
    reached = reached.cpu().numpy()
    if not reached.all():
        bad = np.nonzero(~reached)[0].tolist()
        raise PlanningError(f"roadmap: start and end not connected: scenes {bad}")
    return [[int(x) for x in row if x >= 0] for row in paths.cpu().numpy()]
