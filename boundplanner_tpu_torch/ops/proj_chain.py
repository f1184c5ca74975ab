"""Kernel B's dependent chain, counted on the host (a design probe, not
used by the port).

Run from the repository root (~30 s on a CPU):

    python -m boundplanner_tpu_torch.ops.proj_chain [FLEET] [--device cpu]

It captures the ``seg_poly_closest`` inputs of the first tick of a cached
fleet (the main path's 128-scene fleet unless FLEET is given) in float32 on
the card (on the CPU with ``--device cpu``), then replays on the host
kernel B's control flow on them (``csrc/line_polytope.cu``: no-op rows
dropped, each Dykstra call stopped after its first sweep that changes
nothing, the outer loop stopped at its fixed point) and prints one JSON
line: the histogram of kept rows, the outer iteration at which each
problem returns its input unchanged, and the chain (row corrections) of
each problem and of each warp's slowest problem (32 consecutive problems,
as the kernel's threads take them), beside the full chain 11 x 4 x R. The
replay rounds as the plain version does (no FMA contraction), so these are
host counts of that rounding, not the card's. It also checks that the
replay's x and phi equal the plain version's (on the host) by value.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from .cuda_proj import DYKSTRA_SWEEPS, OUTER_ITERS, line_polytope_projection_plain

FLEET = os.path.join(".fleet_cache", "fleet_b128_s7_segs4.pkl")
WARP = 32
NO_OP_B = -1e26   # a zero row with b >= this (or NaN) changes nothing


class _Captured(Exception):
    pass


def capture_tick_inputs(carry, q0, obs, model):
    """The (a, b, p0, p1) that the first tick of ``fleet_rollout`` hands to
    ``seg_poly_closest`` (the link collision sets), on the fleet's device
    and dtype. The tick stops there. ``model`` takes the eager route
    (``graph=False``): a replayed graph makes no Python call."""
    from ..parallel.batch import fleet_rollout
    from ..planner import set_finder

    got = []

    def grab(*args):
        got.extend(t.contiguous().clone() for t in args)
        raise _Captured

    real = set_finder.seg_poly_closest
    set_finder.seg_poly_closest = grab
    try:
        fleet_rollout(carry, q0, obs, model, 1)
    except _Captured:
        pass
    finally:
        set_finder.seg_poly_closest = real
    return tuple(got)


def kept_rows(a, b):
    """(P, R) mask of the rows kernel B keeps: every row but the zero rows
    whose b is NaN or >= -1e26 (numpy or torch)."""
    zero = (a == 0).all(-1)
    return ~zero | (b < NO_OP_B)


def _dot3(u, v):
    return (u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1]) + u[..., 2] * v[..., 2]


def replay(a, b, p0, p1):
    """Kernel B's control flow on numpy arrays, vectorized over problems,
    in their dtype. Returns (x (P, 3), phi (P,), counts) with counts
    ``kept`` (P,), ``outer_fixed`` (P,: the outer iteration that returned
    its input, OUTER_ITERS if none did) and ``chain`` (P,: row corrections
    run). The clamp is the kernel's (a NaN violation counts as 0)."""
    a, b, p0, p1 = (np.asarray(t) for t in (a, b, p0, p1))
    dt = a.dtype.type
    count, rows = b.shape
    keep = kept_rows(a, b)
    order = np.argsort(~keep, axis=1, kind="stable")      # kept rows first, in order
    a = np.take_along_axis(a, order[..., None], axis=1)
    b = np.take_along_axis(b, order, axis=1)
    kept = keep.sum(axis=1)
    an2 = np.maximum(_dot3(a, a), dt(1e-12))
    d = p1 - p0
    denom = np.maximum(_dot3(d, d), dt(1e-12))
    chain = np.zeros(count, np.int64)

    def dykstra(y, live):
        y = y.copy()
        e = np.zeros_like(a)
        run = live.copy()
        for _ in range(DYKSTRA_SWEEPS):
            y_before = y.copy()
            same = np.ones(count, bool)
            for r in range(rows):
                m = run & (r < kept)
                w = y + e[:, r]
                viol = (_dot3(a[:, r], w) - b[:, r]) / an2[:, r]
                s = np.where(viol > 0, viol, dt(0))[:, None] * a[:, r]
                same &= ~m | np.all(s == e[:, r], axis=1)
                e[m, r] = s[m]
                y[m] = (w - s)[m]
                chain[m] += 1
            run &= ~(same & np.all(y == y_before, axis=1))
        return y

    def seg_phi(x):
        return np.clip(_dot3(x - p0, d) / denom, dt(0), dt(1))

    with np.errstate(invalid="ignore", over="ignore"):
        x = dykstra(p0, np.ones(count, bool))
        live = np.ones(count, bool)
        outer_fixed = np.full(count, OUTER_ITERS)
        for it in range(OUTER_ITERS):
            z = dykstra(p0 + seg_phi(x)[:, None] * d, live)
            fixed = live & np.all(z == x, axis=1)
            x = np.where(live[:, None], z, x)
            outer_fixed[fixed] = it
            live &= ~fixed
        phi = seg_phi(x)
    return x, phi, {"kept": kept, "outer_fixed": outer_fixed, "chain": chain}


def warp_max(chain):
    """Each warp's slowest problem: the max over 32 consecutive problems."""
    pad = (-len(chain)) % WARP
    return np.concatenate([chain, np.zeros(pad, chain.dtype)]).reshape(-1, WARP).max(axis=1)


def summary(counts, rows):
    hist = lambda v: {int(k): int(n) for k, n in zip(*np.unique(v, return_counts=True))}
    chain, kept = counts["chain"], counts["kept"]
    active = kept > 0
    warps = warp_max(chain)
    return {"problems": int(len(chain)), "rows": int(rows),
            "kept_rows_hist": hist(kept),
            "outer_fixed_hist_active": hist(counts["outer_fixed"][active]),
            "outer_fixed_hist_inactive": hist(counts["outer_fixed"][~active]),
            "chain_full": (1 + OUTER_ITERS) * DYKSTRA_SWEEPS * int(rows),
            "chain_mean": float(chain.mean()), "chain_max": int(chain.max()),
            "chain_mean_active": float(chain[active].mean()) if active.any() else 0.0,
            "warp_max_mean": float(warps.mean()), "warp_max_max": int(warps.max())}


def main(argv):
    import argparse

    from ..config import perf_mpc_params
    from ..mpc.bound_mpc import FleetMPC
    from ..parallel.fleet_cache import load, to_torch
    from ..utils.device import DEFAULT_DEVICE, checked_device

    ap = argparse.ArgumentParser(prog="python -m boundplanner_tpu_torch.ops.proj_chain")
    ap.add_argument("fleet", nargs="?", default=FLEET)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the tick runs up to its link sets (the card by default)")
    args_ns = ap.parse_args(argv)
    device = checked_device(args_ns.device)
    payload = load(args_ns.fleet)
    carry, q0, obs = to_torch((payload["carry"], payload["q0"], payload["obs"]), device,
                              torch.float32)
    model = FleetMPC(perf_mpc_params(), device=device, dtype=torch.float32, graph=False)
    # the count replay and its plain reference run on the host
    args = tuple(t.cpu() for t in capture_tick_inputs(carry, q0, obs, model))
    x, phi, counts = replay(*(t.numpy() for t in args))
    xp, phip, _ = line_polytope_projection_plain(*args)
    equal = lambda u, v: bool(np.array_equal(u, v.numpy(), equal_nan=True))
    print(json.dumps({"fleet": args_ns.fleet, "tick": 0, "device": str(device),
                      "dtype": "float32", **summary(counts, args[1].shape[1]),
                      "equal_to_plain": equal(x, xp) and equal(phi, phip)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
