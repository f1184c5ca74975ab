"""The reader of kernel C's device time (the dense IPM's KKT matrix,
``csrc/kkt_gram.cu``), shared by ``metrics/kkt_gram_device_ms.*.py``."""

from benchmark import harness

# kernel C and its second pass, where a call splits the rows of G
KERNEL_C = "kkt_gram_kernel"
KERNEL_C_SUM = "kkt_gram_sum_kernel"


def kkt_gram_device_ms(run):
    """Kernel C's device time a traced tick, in ms: its events by device
    name, the first pass and, where a call splits the rows of G, the
    second. A tick builds the dense IPM's KKT matrix once per IPM
    iteration, ``sqp_iters x qp_iters`` times; where the first pass's
    launches are not that count a tick, or the second pass's neither none
    nor as many, the work is not this and the reader reads nothing (as in
    a program without the kernel)."""
    tr = run["trace"]
    if not tr or not tr["device"]:
        return None
    from benchmark.reference.bmpc import config as ref_config

    cfg = harness.mpc_params(ref_config, run["config"])
    calls = tr["ticks"] * cfg.sqp_iters * cfg.qp_iters
    first = [hi - lo for name, lo, hi in tr["device"] if KERNEL_C in name]
    second = [hi - lo for name, lo, hi in tr["device"] if KERNEL_C_SUM in name]
    if not first or len(first) != calls or len(second) not in (0, calls):
        return None
    return 1e3 * (sum(first) + sum(second)) / tr["ticks"]
