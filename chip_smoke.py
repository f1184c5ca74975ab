#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``boundplanner_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py [--out DIR]

Phases (each asserts; any failure exits non-zero):

1. the card's name and power limit (nvidia-smi); build both CUDA kernels
   from ``boundplanner_tpu_torch/csrc`` with nvcc;
2. kernel A (Cholesky + inverse) against its plain PyTorch version on the
   card, at the fleet's shapes (128, 136, 136) and (1, 136, 136);
3. kernel B (segment-polytope projection) against its plain version at
   P = 12288 and P = 1, R = 15, with zero-padded rows and inactive
   obstacles;
4. a small f64 rollout on the card against the same rollout on the CPU;
5. the main path: the cached 128-scene fleet, ``FleetMPC(perf_mpc_params())``
   -> ``chunked_rollout`` for 20 ticks in f32 (warm-up, then timed), with
   the kernels' launch counts, fleet quality and single-scene tick latency.

Earlier lines print JSON with the numbers; the line before the last is the
kernels' summary, the last line ``{"ok": true, "device": {...}}``. No JAX
is imported. ``--out DIR`` also writes the results and the compiler's
report there.
"""

import json
import os
import subprocess
import sys
import time

FLEET = os.path.join(".fleet_cache", "fleet_b128_s7_segs4.pkl")
N_TICKS = 20
CHUNK = 128
LATENCY_REPS = 50


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call, timed with CUDA events after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def spd_batch(rng, bsz, n=136, m=400):
    """SPD matrices shaped like the IPM's KKT: G^T diag(w) G + P, with the
    interior-point weights w = z/s spread over four decades."""
    import numpy as np

    g = rng.normal(size=(bsz, m, n)) / np.sqrt(m)
    w = 10.0 ** rng.uniform(-2.0, 2.0, size=(bsz, m))
    k = np.einsum("bmi,bm,bmj->bij", g, w, g) + 1e-2 * np.eye(n)
    return k.astype(np.float32)


def phase_kernel_a(rng, dev):
    import numpy as np
    import torch
    from boundplanner_tpu_torch.ops.linalg import kkt_inverse, kkt_inverse_plain

    out = {}
    for bsz in (128, 1):
        k = torch.from_numpy(spd_batch(rng, bsz)).to(dev)
        li = kkt_inverse(k)
        lp = kkt_inverse_plain(k)
        torch.cuda.synchronize()
        assert torch.isfinite(li).all(), "kernel A: non-finite output"
        upper = torch.triu(li, diagonal=1)
        assert (upper == 0).all(), "kernel A: strict upper triangle not exactly 0"
        eye = torch.eye(k.shape[-1], device=dev)
        res_k = (li @ k @ li.mT - eye).abs().amax().item()
        res_p = (lp @ k @ lp.mT - eye).abs().amax().item()
        abs_err = (li - lp).abs().amax().item()
        rel_err = abs_err / lp.abs().amax().item()
        ms = cuda_ms(lambda: kkt_inverse(k), 20)
        plain_ms = cuda_ms(lambda: kkt_inverse_plain(k), 3)
        row = {"phase": "kernel_a", "shape": list(k.shape), "max_abs_err": abs_err,
               "max_rel_err": rel_err, "resid_inf_kernel": res_k,
               "resid_inf_plain": res_p, "upper_zero": True, "ms": ms,
               "plain_ms": plain_ms}
        emit(row)
        # f32 at these condition numbers: both factors carry ~cond*eps
        # error; the kernel must be as good an inverse factor as the plain
        assert rel_err < 1e-3, f"kernel A disagrees with plain: {rel_err}"
        assert res_k <= max(4.0 * res_p, 1e-3), f"kernel A residual {res_k} vs {res_p}"
        out[bsz] = row
    return out[128]


def projection_batch(rng, count, rows=15, n_active=4, n_obs=16):
    """Problems shaped like the tick's: every 16 obstacles share a segment,
    4 of them active boxes (6 rows + 9 zero rows at b = 10 - 0.001), the
    rest inactive (all rows a = 0, b = 10 - 0.001)."""
    import numpy as np

    a = np.zeros((count, rows, 3))
    b = np.full((count, rows), 10.0 - 0.001)
    p0 = np.zeros((count, 3))
    p1 = np.zeros((count, 3))
    eye = np.eye(3)
    for i in range(count):
        if i % n_obs < n_active:
            center = rng.uniform(-0.5, 0.5, 3)
            half = rng.uniform(0.05, 0.2, 3)
            a[i, :6] = np.vstack([eye, -eye])
            b[i, :6] = np.concatenate([center + half, -(center - half)]) - 0.001
        if i % n_obs == 0:
            s0 = rng.uniform(-0.8, 0.8, 3)
            s1 = s0 + rng.uniform(-0.1, 0.1, 3)
        p0[i], p1[i] = s0, s1
    f = lambda x: np.ascontiguousarray(x, dtype=np.float32)
    return f(a), f(b), f(p0), f(p1)


def phase_kernel_b(rng, dev):
    import torch
    from boundplanner_tpu_torch.ops.cuda_proj import (
        line_polytope_projection, line_polytope_projection_plain)

    out = {}
    for count in (12288, 1):
        args = [torch.from_numpy(x).to(dev) for x in projection_batch(rng, count)]
        xk, phik, dk = line_polytope_projection(*args)
        xp, phip, dp = line_polytope_projection_plain(*args)
        torch.cuda.synchronize()
        for t in (xk, phik, dk):
            assert torch.isfinite(t).all(), "kernel B: non-finite output"
        err = max((xk - xp).abs().amax().item(), (phik - phip).abs().amax().item(),
                  (dk - dp).abs().amax().item())
        ms = cuda_ms(lambda: line_polytope_projection(*args), 50)
        plain_ms = cuda_ms(lambda: line_polytope_projection_plain(*args), 5)
        row = {"phase": "kernel_b", "problems": count, "rows": 15,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        emit(row)
        # same f32 arithmetic up to FMA contraction in the kernel's sums
        assert err < 1e-4, f"kernel B disagrees with plain: {err}"
        out[count] = row
    return out[12288]


def phase_small_f64(payload, cfg, dev):
    """2 scenes x 2 ticks in f64: the card's route (kernel A in every IPM,
    the exact projection IPM) against the CPU's plain route."""
    import numpy as np
    import torch
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.parallel.batch import fleet_rollout
    from boundplanner_tpu_torch.parallel.fleet_cache import to_numpy, to_torch, tree_map

    small = tree_map(lambda a: np.asarray(a)[:2],
                     (payload["carry"], payload["q0"], payload["obs"]))
    res = {}
    for where in ("cpu", dev):
        c, q, o = to_torch(small, where, torch.float64)
        model = FleetMPC(cfg).to(where, torch.float64)
        _, recs = fleet_rollout(c, q, o, model, 2)
        res[str(where)] = to_numpy(recs)
    a, b = res["cpu"], res[str(dev)]
    err = max(float(np.max(np.abs(a[k] - b[k]))) for k in ("q", "phi", "p"))
    same = bool(np.array_equal(a["success"], b["success"]))
    emit({"phase": "small_f64_cpu_vs_card", "max_abs_err_q_phi_p": err,
          "same_success": same})
    assert same and err < 1e-6, f"f64 card rollout disagrees with the CPU: {err}"


def phase_main(payload, cfg, dev):
    import numpy as np
    import torch
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.ops.cuda_proj import line_polytope_projection
    from boundplanner_tpu_torch.ops.linalg import kkt_inverse
    from boundplanner_tpu_torch.parallel.batch import chunked_rollout, fleet_rollout
    from boundplanner_tpu_torch.parallel.fleet_cache import to_torch, tree_map

    carry, q0, obs = to_torch((payload["carry"], payload["q0"], payload["obs"]),
                              dev, torch.float32)
    batch = q0.shape[0]
    model = FleetMPC(cfg).to(dev, torch.float32)

    chunked_rollout(carry, q0, obs, model, N_TICKS, chunk=CHUNK)  # warm-up
    torch.cuda.synchronize()
    kkt_inverse.launches = 0
    line_polytope_projection.launches = 0
    t0 = time.perf_counter()
    final, recs = chunked_rollout(carry, q0, obs, model, N_TICKS, chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"chol_inverse": kkt_inverse.launches,
                "line_polytope": line_polytope_projection.launches}

    for k, v in recs.items():
        assert v.shape[:2] == (batch, N_TICKS), (k, v.shape)
        assert torch.isfinite(v.float()).all(), f"non-finite record {k}"
    for leaf in final:
        if isinstance(leaf, torch.Tensor):
            assert torch.isfinite(leaf.float()).all(), "non-finite final carry"
    want_a = cfg.sqp_iters * cfg.qp_iters * N_TICKS * (batch // CHUNK)
    want_b = N_TICKS * (batch // CHUNK)
    assert launches["chol_inverse"] == want_a, (launches, want_a)
    assert launches["line_polytope"] == want_b, (launches, want_b)

    success_rate = float(recs["success"].float().mean())
    max_viol = float(recs["viol"].amax())
    mean_phi = float(recs["phi"][:, -1].mean())

    one = tree_map(lambda t: t[:1], (carry, q0, obs))
    fleet_rollout(*one, model, 1)
    torch.cuda.synchronize()
    lats = []
    for _ in range(LATENCY_REPS):
        t1 = time.perf_counter()
        _, r1 = fleet_rollout(*one, model, 1)
        float(r1["phi"][0, -1])
        lats.append(1e3 * (time.perf_counter() - t1))
    lats = np.asarray(lats)
    result = {
        "phase": "main_path",
        "metric": "boundmpc_solves_per_s_per_chip",
        "workload": f"random_fleet_{batch}",   # bench.py's name for this fleet
        "ticks": N_TICKS,
        "value": batch * N_TICKS / wall,
        "unit": "solves/s",
        "success_rate": success_rate,
        "max_viol": max_viol,
        "mean_phi_final": mean_phi,
        "tick_latency_ms_p50": float(np.percentile(lats, 50)),
        "tick_latency_ms_p95": float(np.percentile(lats, 95)),
        "tick_latency_ms_p99": float(np.percentile(lats, 99)),
        "tick_latency_ms_max": float(np.max(lats)),
        "latency_reps": LATENCY_REPS,
        "wall_s": wall,
        "launches": launches,
    }
    emit(result)
    # sanity floor against a broken port, below the CPU-mesh basin (0.932)
    assert success_rate >= 0.90, f"success_rate {success_rate} < 0.90"
    return result


def main(argv):
    out_dir = None
    if "--out" in argv:
        out_dir = argv[argv.index("--out") + 1]
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "boundplanner_tpu_torch")):
        print("chip_smoke: boundplanner_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card", file=sys.stderr)
        return 2
    os.chdir(root)
    sys.path.insert(0, root)

    import numpy as np
    from boundplanner_tpu.config import perf_mpc_params
    from boundplanner_tpu_torch.ops import _build
    from boundplanner_tpu_torch.parallel.fleet_cache import load

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    path, build_s = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": build_s, "library": os.path.relpath(path, root)})

    rng = np.random.default_rng(0)
    a = phase_kernel_a(rng, dev)
    b = phase_kernel_b(rng, dev)
    cfg = perf_mpc_params()
    payload = load(FLEET)
    phase_small_f64(payload, cfg, dev)
    main_res = phase_main(payload, cfg, dev)

    kernels = {"kernels": [
        {"name": "chol_inverse", "route": "cuda",
         "source": "boundplanner_tpu_torch/csrc/chol_inverse.cu",
         "replaces": "boundplanner_tpu/ops/pallas_chol.py:386",
         "launches": main_res["launches"]["chol_inverse"],
         "max_abs_err": a["max_abs_err"], "ms": a["ms"], "plain_ms": a["plain_ms"]},
        {"name": "line_polytope", "route": "cuda",
         "source": "boundplanner_tpu_torch/csrc/line_polytope.cu",
         "replaces": "boundplanner_tpu/ops/pallas_proj.py:95",
         "launches": main_res["launches"]["line_polytope"],
         "max_abs_err": b["max_abs_err"], "ms": b["ms"], "plain_ms": b["plain_ms"]},
    ]}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump({"card": card, "main": main_res, **kernels}, f, indent=1)
        with open(path + ".log") as src, open(os.path.join(out_dir, "nvcc.log"), "w") as dst:
            dst.write(src.read())
    print(card, flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
