"""Scenario-sharded fleets over the devices of one process
(port of ``boundplanner_tpu/parallel/mesh.py``).

Scenes never communicate, so the mesh is a list of devices along one
scenario axis: every batched tree is split on its leading axis into
contiguous equal shards, one per device, and each device rolls its shard
out as `batch.closed_loop_rollout` does, without the escalation retry
(JAX's rollout here is ``vmap`` of ``closed_loop_rollout``). The three
fleet diagnostics are reduced over the gathered records at the end.

The shards roll out one after another. The tick is bound by the host
issuing its kernels (an H100 is busy ~5 % of a tick), and its
transforms keep their levels per process, so one process cannot drive
two cards at once; several cards scale through `parallel.distributed`,
one process per card.
"""

from __future__ import annotations

import torch

from ..config import MPCParams
from ..mpc.bound_mpc import FleetMPC
from ..utils.device import DEFAULT_DEVICE, checked_device
from ..utils.tree import tree_map
from .batch import _concat, _rollout


def make_mesh(n_devices: int | None = None, devices=None) -> list:
    """The devices of the scenario axis: the first ``n_devices`` CUDA
    devices (all by default; raises at once without a card), or the given
    ``devices`` (for example ``["cpu", "cpu"]``)."""
    if devices is None:
        checked_device(DEFAULT_DEVICE)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return [checked_device(d) for d in devices]


def shard_batch(tree, mesh: list) -> list:
    """Split every tensor leaf of a batched tree on its leading axis into
    ``len(mesh)`` contiguous equal shards; shard i moves to ``mesh[i]``
    (0-d leaves are copied to every device)."""
    leads = set()
    tree_map(lambda t: leads.add(t.shape[0]) if t.dim() else None, tree)
    (lead,) = leads
    n = len(mesh)
    if lead % n:
        raise ValueError(f"batch {lead} not divisible over {n} devices")
    per = lead // n
    return [tree_map(lambda t, lo=i * per: (t[lo:lo + per] if t.dim() else t).to(dev), tree)
            for i, dev in enumerate(mesh)]


def fleet_diagnostics(recs) -> dict:
    """The fleet's success share, worst attempted violation and mean final
    path progress, over every scene and tick of the records."""
    return {"success_rate": float(recs["success"].double().mean()),
            "max_viol": float(recs["viol"].max()),
            "mean_phi_final": float(recs["phi"][:, -1].double().mean())}


def sharded_rollout(carry, q0, obs, cfg: MPCParams, n_ticks: int, mesh: list):
    """Closed-loop fleet rollout, scenario-sharded over ``mesh``.

    ``carry``/``q0``/``obs`` hold tensors with a leading scene axis
    divisible by the mesh size, in the dtype of the rollout. Each device
    builds its own `FleetMPC` and rolls its shard out in turn, with no
    escalation retry whatever ``cfg.esc_lanes`` says, as in JAX. Returns
    (final carries, per-tick records, diagnostics): the shards
    concatenated in device order on ``mesh[0]``, the diagnostics over the
    whole fleet."""
    shards = zip(shard_batch(carry, mesh), shard_batch(q0, mesh), shard_batch(obs, mesh))
    gather = lambda tree: tree_map(lambda t: t.to(mesh[0]), tree)
    out = [gather(_rollout(c, q, o, FleetMPC(cfg, device=dev, dtype=q0.dtype), n_ticks,
                           escalate=False))
           for (c, q, o), dev in zip(shards, mesh)]
    final = _concat([f for f, _ in out])
    recs = _concat([r for _, r in out])
    return final, recs, fleet_diagnostics(recs)
