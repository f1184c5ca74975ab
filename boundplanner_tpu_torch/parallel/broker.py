"""Cross-scene batching broker for host-side planners
(port of ``boundplanner_tpu/parallel/broker.py``).

N planner threads share batched executions: a call enqueues its (numpy)
arguments under a kernel key; the first caller of a key becomes the
leader, lingers briefly so sibling threads can join, then stacks all queued
arguments, pads the batch to a power of two by repeating row 0, runs ONE
call of the registered batch-major function on the broker's device and
dtype, and hands every caller its row of the results as numpy.

No deadlock by construction: a leader never waits for a specific number of
joiners, and an error in the batched call is re-raised in every caller.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, checked_device
from ..utils.tree import to_numpy, to_torch, tree_map, tree_stack


def _pad_pow2(batched, k: int, max_batch: int):
    """Pad the leading axis of a stacked tree of ``k`` calls to the next
    power of two (at most ``max_batch``) by repeating row 0. Returns
    (padded tree, width)."""
    if k > max_batch:
        raise ValueError(f"batch of {k} exceeds max_batch={max_batch}; chunk first")
    target = 1
    while target < k:
        target *= 2
    target = min(target, max_batch)

    def pad(leaf):
        if leaf.shape[0] == target:
            return leaf
        reps = np.broadcast_to(leaf[:1], (target - leaf.shape[0],) + leaf.shape[1:])
        return np.concatenate([leaf, reps])

    return tree_map(pad, batched), target


class _Ticket:
    __slots__ = ("args", "event", "result", "error")

    def __init__(self, args):
        self.args = args
        self.event = threading.Event()
        self.result = None
        self.error = None


class BatchBroker:
    """Coalesces same-key kernel calls from multiple threads into one
    batched execution.

    register(key, fn): ``fn`` is batch-major: it maps tensors with a
    leading batch axis to results with the same leading axis.
    call(key, *args): ``args`` are ONE call's numpy arrays (or trees of
    them); blocks until the coalesced batch has run and returns this
    call's row of the results as numpy. ``calls_by_key`` counts the calls
    served under each key.
    """

    def __init__(self, linger: float = 0.003, max_batch: int = 64,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        # short default linger: every leader sleeps the full window, so
        # low-concurrency callers should not pay a coalescing budget; the
        # fleet builder passes linger=0.030
        self.linger = linger
        self.max_batch = max_batch
        self.device = checked_device(device)
        self.dtype = dtype
        self._lock = threading.Lock()
        self._pending: Dict[str, List[_Ticket]] = {}
        self._fns: Dict[str, Callable] = {}
        self.batches_run = 0
        self.calls_served = 0
        self.coalesced_calls = 0
        self.calls_by_key: Dict[str, int] = {}

    def register(self, key: str, fn: Callable):
        self._fns[key] = fn

    def _run(self, key, chunk):
        stacked = tree_stack([t.args for t in chunk])
        padded, _ = _pad_pow2(stacked, len(chunk), self.max_batch)
        out = to_numpy(self._fns[key](*to_torch(padded, self.device, self.dtype)))
        for i, t in enumerate(chunk):
            t.result = tree_map(lambda leaf: leaf[i], out)

    def call(self, key: str, *args) -> Any:
        ticket = _Ticket(args)
        with self._lock:
            queue = self._pending.setdefault(key, [])
            queue.append(ticket)
            leader = len(queue) == 1
        if not leader:
            ticket.event.wait()
            if ticket.error is not None:
                raise ticket.error
            return ticket.result

        time.sleep(self.linger)
        with self._lock:
            batch = self._pending.pop(key)
        k = len(batch)
        n_runs = 0
        try:
            # chunks of at most max_batch keep the batch sizes in a small,
            # bounded set {1, 2, 4, ..., max_batch}
            for lo in range(0, k, self.max_batch):
                self._run(key, batch[lo : lo + self.max_batch])
                n_runs += 1
        except BaseException as err:
            for t in batch:
                t.error = err
            raise
        finally:
            with self._lock:
                self.batches_run += n_runs
                self.calls_served += k
                self.coalesced_calls += max(k - n_runs, 0)
                self.calls_by_key[key] = self.calls_by_key.get(key, 0) + k
            for t in batch:
                if t is not ticket:
                    t.event.set()
        return ticket.result


def register_planner_kernels(broker, max_set_size: int = 20, device_search: bool = False,
                             max_via: int = 6):
    """Register the BoundPlanner device-kernel surface on a broker: the
    functions of `planner.planner.planner_kernels` under their keys, which
    `planner.BoundPlanner`'s wrappers route through the broker.

    ``device_search`` also registers the batched min-plus shortest path
    ("spath", `planner.device_search.shortest_path_device`); the planner
    then routes its roadmap searches through it. Off by default: on the
    H100 one call for 128 roadmaps took longer than their 128 host
    Dijkstras (`PERF.md`), and a search is milliseconds of a plan of
    seconds."""
    from ..planner.planner import planner_kernels

    for key, fn in planner_kernels(max_set_size, max_via).items():
        broker.register(key, fn)
    if device_search:
        from ..planner.device_search import shortest_path_device

        broker.register("spath", shortest_path_device)
