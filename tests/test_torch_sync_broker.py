"""The port's phase-synchronous broker (``parallel/sync_broker.py``) on toy
kernels: the behaviours of the JAX package's ``tests/test_sync_broker.py``
(lockstep coalescing, irregular call counts without deadlock, mixed keys,
width 1, an error delivered to every parked caller, an unregistered key,
chunking beyond ``max_batch``), each JAX case run through both brokers
with the same expected counters, plus a stress test with more workers than
cores. Every thread is joined with a timeout, so a deadlock fails the test
instead of hanging it.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from boundplanner_tpu.parallel.sync_broker import PhaseSyncBroker as JaxBroker
from boundplanner_tpu_torch.parallel.sync_broker import PhaseSyncBroker

torch.set_num_threads(1)
JOIN_S = 60.0


def port_broker(**kw):
    return PhaseSyncBroker(device="cpu", dtype=torch.float64, **kw)


BROKERS = [pytest.param(port_broker, id="port"), pytest.param(JaxBroker, id="jax")]


def run_workers(n, body, brk):
    """Enter all workers before starting any (the broker's startup
    contract); each body calls worker_exit in a finally. Fails if a thread
    is still alive JOIN_S after the start."""
    errs = []

    def wrapped(i):
        try:
            body(i)
        except Exception as e:  # surfaced below
            errs.append(e)

    for _ in range(n):
        brk.worker_enter()
    threads = [threading.Thread(target=wrapped, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + JOIN_S
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "deadlock: a worker is still parked"
    if errs:
        raise errs[0]


@pytest.mark.parametrize("make", BROKERS)
def test_lockstep_workers_coalesce_full_width(make):
    """4 workers x 3 rounds -> exactly 3 batches, each of width 4."""
    brk = make()
    brk.register("sq", lambda x: x * x)
    results = {}

    def body(i):
        try:
            results[i] = [brk.call("sq", np.full(3, float(10 * i + r))) for r in range(3)]
        finally:
            brk.worker_exit()

    run_workers(4, body, brk)
    for i in range(4):
        for r in range(3):
            np.testing.assert_array_equal(results[i][r], np.full(3, float(10 * i + r)) ** 2)
    assert brk.calls_served == 12
    assert brk.batches_run == 3
    assert brk.stats["width_hist"] == {4: 3}


@pytest.mark.parametrize("make", BROKERS)
def test_irregular_call_counts_no_deadlock(make):
    """Worker i makes i + 1 calls; exits shrink the barrier, so later rounds
    flush at the smaller width."""
    brk = make()
    brk.register("neg", lambda x: -x)
    results = {}

    def body(i):
        try:
            results[i] = [brk.call("neg", np.arange(3.0) + i + r) for r in range(i + 1)]
        finally:
            brk.worker_exit()

    run_workers(4, body, brk)
    for i in range(4):
        for r in range(i + 1):
            np.testing.assert_array_equal(results[i][r], -(np.arange(3.0) + i + r))
    assert brk.calls_served == 10
    assert brk.batches_run == 4
    assert brk.stats["mean_width"] == 2.5
    assert brk.stats["width_hist"] == {1: 1, 2: 1, 4: 2}


@pytest.mark.parametrize("make", BROKERS)
def test_mixed_keys_flush_together(make):
    brk = make()
    brk.register("sq", lambda x: x * x)
    brk.register("neg", lambda x: -x)
    results = {}

    def body(i):
        try:
            key = "sq" if i % 2 == 0 else "neg"
            results[i] = (key, brk.call(key, np.full(2, float(i + 1))))
        finally:
            brk.worker_exit()

    run_workers(4, body, brk)
    for i in range(4):
        key, val = results[i]
        exp = np.full(2, float(i + 1))
        np.testing.assert_array_equal(val, exp**2 if key == "sq" else -exp)
    assert brk.calls_served == 4
    assert brk.batches_run == 2


@pytest.mark.parametrize("make", BROKERS)
def test_single_worker_width_one(make):
    brk = make()
    brk.register("neg", lambda x: -x)
    brk.worker_enter()
    try:
        out = brk.call("neg", np.arange(4.0))
    finally:
        brk.worker_exit()
    np.testing.assert_array_equal(out, -np.arange(4.0))
    assert brk.stats["width_hist"] == {1: 1}


@pytest.mark.parametrize("make", BROKERS)
def test_kernel_error_delivered_to_all_parked_callers(make):
    """Unstackable shapes fail the batch: every waiting thread raises."""
    brk = make()
    brk.register("sq", lambda x: x * x)
    caught = {}

    def body(i):
        try:
            try:
                brk.call("sq", np.zeros(3 + i))
            except Exception as e:
                caught[i] = type(e)
        finally:
            brk.worker_exit()

    run_workers(2, body, brk)
    assert set(caught) == {0, 1}
    assert caught[0] is caught[1]
    assert brk.calls_served == 0


def test_kernel_body_error_reaches_every_caller():
    """An exception raised inside the registered function itself."""
    brk = port_broker()

    def boom(x):
        raise RuntimeError("kernel fault")

    brk.register("boom", boom)
    caught = []

    def body(i):
        try:
            with pytest.raises(RuntimeError, match="kernel fault"):
                brk.call("boom", np.zeros(2))
            caught.append(i)
        finally:
            brk.worker_exit()

    run_workers(3, body, brk)
    assert sorted(caught) == [0, 1, 2]


@pytest.mark.parametrize("make", BROKERS)
def test_unregistered_key_raises(make):
    with pytest.raises(KeyError):
        make().call("nope", np.zeros(3))


@pytest.mark.parametrize("make", BROKERS)
def test_chunking_beyond_max_batch(make):
    brk = make(max_batch=4)
    brk.register("sq", lambda x: x * x)
    results = {}

    def body(i):
        try:
            results[i] = brk.call("sq", np.full(2, float(i)))
        finally:
            brk.worker_exit()

    run_workers(6, body, brk)
    for i in range(6):
        np.testing.assert_array_equal(results[i], np.full(2, float(i)) ** 2)
    assert brk.calls_served == 6
    assert brk.batches_run == 2
    assert brk.stats["width_hist"] == {4: 1, 2: 1}


def test_port_runs_tensors_on_its_device_and_dtype():
    """The registered function sees one stacked, padded batch of tensors on
    the broker's device in its dtype; each caller gets its numpy row."""
    brk = PhaseSyncBroker(device="cpu", dtype=torch.float32)
    seen = []

    def fn(x, k):
        seen.append((x.device.type, x.dtype, tuple(x.shape), k.dtype))
        return x * k[:, None]

    brk.register("scale", fn)
    results = {}

    def body(i):
        try:
            results[i] = brk.call("scale", np.full(2, float(i)), np.asarray(i + 1, np.int64))
        finally:
            brk.worker_exit()

    run_workers(3, body, brk)
    assert seen == [("cpu", torch.float32, (4, 2), torch.int64)]
    for i in range(3):
        assert results[i].dtype == np.float32
        np.testing.assert_array_equal(results[i], np.full(2, float(i * (i + 1))))


def test_stress_many_workers_irregular():
    """32 threads (more than this machine's cores), each a different number
    of calls on two keys, with a very short switch interval: every result
    is its caller's and the counters add up (a lost update would break
    them)."""
    brk = port_broker(max_batch=8)
    brk.register("sq", lambda x: x * x)
    brk.register("neg", lambda x: -x)
    n = 32
    results = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def body(i):
        try:
            out = []
            for r in range(1 + i % 7):
                key = "sq" if (i + r) % 2 else "neg"
                x = np.array([i, r], dtype=np.float64)
                out.append((key, x, brk.call(key, x)))
            results[i] = out
        finally:
            brk.worker_exit()

    try:
        run_workers(n, body, brk)
    finally:
        sys.setswitchinterval(old)
    total = 0
    for i in range(n):
        assert len(results[i]) == 1 + i % 7
        for key, x, got in results[i]:
            np.testing.assert_array_equal(got, x * x if key == "sq" else -x)
            total += 1
    assert brk.calls_served == total
    assert brk.coalesced_calls == total - brk.batches_run
    assert sum(brk.width_hist.values()) == brk.batches_run
    assert max(brk.width_hist) <= 8
