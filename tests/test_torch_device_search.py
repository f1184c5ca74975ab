"""The port's batched min-plus shortest path against the JAX kernel and the
host Dijkstra: random connected roadmaps (paths and float32 costs equal to
JAX's by value, costs equal to the host optimum within rtol 1e-5, the JAX
test's bar), integer weights with ties (the same first-index tie rule), an
unreachable destination, a batched fleet call, and a float64 batch that
relaxes in float32.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from boundplanner_tpu.planner import device_search as jds
from boundplanner_tpu_torch.planner import device_search as ds
from boundplanner_tpu_torch.planner.roadmap import Junction, PlanningError, SetRoadmap

torch.set_num_threads(1)


def random_roadmap(rng, n_junctions, integer=False):
    """A SetRoadmap with random positive weights over a random connected
    topology (dummy junction payloads: only the adjacency matters)."""
    rm = SetRoadmap(w_size=0.0, w_bias=0.0, c_fit=0.0)
    for _ in range(n_junctions):
        rm.junctions.append(Junction(a=np.zeros((1, 3)), b=np.zeros(1), owners=(0, 0),
                                     anchor=np.zeros(3), via=np.zeros(4), fits=True))
        rm._adj.append({})
    weight = ((lambda: float(rng.integers(1, 4))) if integer
              else (lambda: float(rng.uniform(0.1, 2.0))))
    order = rng.permutation(n_junctions)
    for i in range(1, n_junctions):
        u, v = int(order[i]), int(order[rng.integers(0, i)])
        rm._adj[u][v] = rm._adj[v][u] = weight()
    for _ in range(2 * n_junctions):
        u, v = (int(x) for x in rng.integers(0, n_junctions, 2))
        if u != v:
            rm._adj[u][v] = rm._adj[v][u] = weight()
    return rm


def path_cost(rm, path):
    return sum(rm._adj[u][v] for u, v in zip(path, path[1:]))


def both(adj):
    dist, path, reached = ds.shortest_path_device(torch.from_numpy(adj))
    jdist, jpath, jreached = jds.shortest_path_device(jnp.asarray(adj))
    return (dist.numpy(), path.numpy(), reached.numpy()), (
        np.asarray(jdist), np.asarray(jpath), np.asarray(jreached))


@pytest.mark.parametrize("integer", [False, True], ids=["uniform", "integer_ties"])
def test_matches_jax_and_host_dijkstra(integer):
    rng = np.random.default_rng(0)
    for _ in range(10):
        rm = random_roadmap(rng, int(rng.integers(4, 20)), integer)
        adj = ds.roadmap_adjacency(rm, 32)
        np.testing.assert_array_equal(adj, jds.roadmap_adjacency(rm, 32))
        (dist, path, reached), (jdist, jpath, jreached) = both(adj)
        assert path.dtype == np.int32 and dist.dtype == np.float32
        np.testing.assert_array_equal(path, jpath)
        np.testing.assert_array_equal(dist, jdist)
        assert bool(reached) and bool(jreached)
        dev = [int(x) for x in path if x >= 0]
        assert dev[0] == 0 and dev[-1] == 1
        assert all(v in rm._adj[u] for u, v in zip(dev, dev[1:]))
        host = rm.shortest_path()
        np.testing.assert_allclose(path_cost(rm, dev), path_cost(rm, host), rtol=1e-5)
        np.testing.assert_allclose(float(dist), path_cost(rm, host), rtol=1e-5)


def test_unreachable_reports():
    rm = random_roadmap(np.random.default_rng(1), 6)
    for u in range(6):
        rm._adj[u].pop(1, None)
    rm._adj[1] = {}
    (dist, path, reached), (jdist, jpath, jreached) = both(ds.roadmap_adjacency(rm, 16))
    assert not bool(reached) and not bool(jreached)
    assert np.all(path == -1)
    np.testing.assert_array_equal(dist, jdist)
    with pytest.raises(PlanningError):
        ds.fleet_shortest_paths([rm], n_pad=16, device="cpu")


def test_fleet_batched_matches_jax():
    rng = np.random.default_rng(2)
    rms = [random_roadmap(rng, int(rng.integers(4, 30))) for _ in range(8)]
    paths = ds.fleet_shortest_paths(rms, n_pad=32, device="cpu")
    assert paths == jds.fleet_shortest_paths(rms, n_pad=32)
    for rm, dev in zip(rms, paths):
        np.testing.assert_allclose(path_cost(rm, dev), path_cost(rm, rm.shortest_path()),
                                   rtol=1e-5)


def test_relaxes_in_float32():
    """A float64 batch relaxes in float32, as JAX does."""
    rm = random_roadmap(np.random.default_rng(3), 12)
    adj = ds.roadmap_adjacency(rm, 16)
    d32 = ds.shortest_path_device(torch.from_numpy(adj))
    d64 = ds.shortest_path_device(torch.from_numpy(adj).double()[None])
    assert d64[0].dtype == torch.float32
    np.testing.assert_array_equal(d64[0][0].numpy(), d32[0].numpy())
    np.testing.assert_array_equal(d64[1][0].numpy(), d32[1].numpy())
