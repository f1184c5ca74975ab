"""The per-layer readers' arithmetic, shared by the metric files that
read the same quantity in different cells (``metrics/<name>.py``)."""

from benchmark import harness, yardstick as ys

KERNEL_A = "chol_inverse_kernel"
KERNEL_B = "line_polytope_kernel"
ITEMSIZE = {"float32": 4, "float64": 8}
LINK_IPM_ITERS = 25


def _trace(run):
    tr = run["trace"]
    return tr if tr and tr["device"] else None


def tick_device_ms(run):
    """The union of the card's events a traced tick, in milliseconds."""
    tr = _trace(run)
    return None if tr is None else 1e3 * tr["busy_s"] / tr["ticks"]


def kernels_per_tick(run):
    """The card's events a traced tick."""
    tr = _trace(run)
    return None if tr is None else len(tr["device"]) / tr["ticks"]


def idle_share(run):
    """1 - (the union of the card's events over the traced window), in %."""
    tr = _trace(run)
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kkt_inverse_roofline(run):
    """Kernel A's share of its roofline in the traced rollout, in %: the
    least time the card could take for the factorizations the
    configuration asks for, over kernel A's device time (its events by
    device name).

    A tick factors every scene's KKT matrix once per IPM iteration,
    ``sqp_iters x qp_iters`` times, n = the OCP's decision variables; on
    the ``ipm`` link route also the link sets' 4 x 4 projection matrices (a
    scene, link and obstacle slot each) once per iteration of that IPM, 25
    times. Each factorization's bound is the larger of its bytes (K's lower
    triangle in, L^{-1} out) over 3.35 TB/s and its operations over the
    dtype's peak, the same work whatever implements the kernel. The
    profiler gives no launch's size, so the launches are counted: where
    they are not the configuration's count, the work is not this, and the
    reader reads nothing."""
    tr = _trace(run)
    if tr is None:
        return None
    from benchmark.reference.bmpc import config as ref_config

    conf = run["config"]
    cfg = harness.mpc_params(ref_config, conf)
    if cfg.kkt_every != 1 or cfg.qp_solver != "ipm" or cfg.esc_lanes:
        return None
    dtype, scenes, ticks = conf["dtype"], tr["scenes"], tr["ticks"]
    kkt = cfg.sqp_iters * cfg.qp_iters
    link = LINK_IPM_ITERS if conf["link_route"] == "ipm" else 0
    events = [hi - lo for name, lo, hi in tr["device"] if KERNEL_A in name]
    if not events or len(events) != ticks * (kkt + link):
        return None
    bound = kkt * ys.bound_s(*ys.kkt_inverse_work(scenes, ys.layout_ints(cfg.n)["nx"],
                                                  ITEMSIZE[dtype]), dtype)[0]
    problems = scenes * ys.NUM_LINK_SETS * ys.OBS_SLOTS
    bound += link * ys.bound_s(*ys.kkt_inverse_work(problems, 4, ITEMSIZE[dtype]), dtype)[0]
    return 100.0 * ticks * bound / sum(events)


def seg_poly_roofline(run):
    """Kernel B's share of its roofline in the traced rollout, in %: the
    bytes of each tick's one launch (the link sets' segment and polytope
    in, the closest point, its parameter and distance out; a problem per
    scene, link and obstacle slot) over 3.35 TB/s, over the kernel's device
    time. Kernel B is bound by its bytes: its operations over the rows its
    Dykstra sweeps keep bound it less. Where the launches are not one a
    tick, the reader reads nothing."""
    tr = _trace(run)
    if tr is None or run["config"]["link_route"] != "dykstra":
        return None
    events = [hi - lo for name, lo, hi in tr["device"] if KERNEL_B in name]
    if not events or len(events) != tr["ticks"]:
        return None
    problems = tr["scenes"] * ys.NUM_LINK_SETS * ys.OBS_SLOTS
    bound = ys.bound_s(ys.seg_poly_work(problems), 0.0, "float32")[0]
    return 100.0 * len(events) * bound / sum(events)


def solve_mfu(run):
    """The whole tick's share of the card's peak, in %: the analytic FLOPs of
    one SQP solve (``yardstick.solve_flops``, the port's ``mpc/flops.py``
    frozen) times the window's solves, over the window's time times the
    dtype's peak outside the tensor cores (67 TFLOP/s float32, 34 float64;
    H100 SXM at 700 W; the card's power limit is on the run's ``setup``
    line)."""
    w = run["window"]
    if not w.get("solves") or not w.get("window_s"):
        return None
    from benchmark.reference.bmpc import config as ref_config

    conf = run["config"]
    flops = ys.solve_flops(harness.mpc_params(ref_config, conf)) * w["solves"]
    return 100.0 * flops / (w["window_s"] * ys.PEAK_OPS_PER_S[conf["dtype"]])


def solves_per_s(run):
    """The scene-ticks of every rollout the window started, over the
    window's whole time, until the last of them ended (host clock)."""
    w = run["window"]
    if not w.get("solves") or not w.get("window_s"):
        return None
    return w["solves"] / w["window_s"]
