"""The benchmark's general part: the manifest, finding a cell's files by
name, the import guard, and the run itself (set-up, window, traced
segment, the comparison with the reference, the result line).

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix. The harness reads, by those names:

- ``configs/<config>.json``: the ``MPCParams`` constructor, its overrides,
  the dtype and the reference's closest-point route;
- ``traffic/<traffic>.json``: the driver kind (``drivers/<kind>.py``) and
  its parameters;
- ``limits/<workload>.json``: the numbers that decide ``correct`` and
  their limits;
- ``metrics/<metric>.py``: one reader per metric, ``read(run) -> float |
  None``; a reader that finds nothing returns None and the metric is left
  out of the line.

A driver module has ``setup(ctx) -> session``; the session has
``window(seconds)``, ``traced(tracer)``, ``counters()``, ``release()`` and
``judge(limits)``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "boundplanner_tpu")


class RunError(Exception):
    """A run that cannot give a result (exit code 2, no result line)."""


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules, each module
    name's part before the first dot compared whole."""
    names = {m.split(".")[0] for m in list(sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, name: str):
    """A module from its file path (names may hold dots: metric files are
    named after their metric)."""
    if not os.path.exists(path):
        raise RunError(f"missing {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise RunError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(man: dict, workload: str) -> dict:
    """Everything the harness reads for ``workload``, found by name."""
    wl = find(man["workloads"], workload, "workload")
    cfg_entry = find(man["configs"], wl["config"], "configuration")
    return {
        "workload": wl,
        "config": {**load_json(os.path.join(ROOT, cfg_entry["file"])), "name": cfg_entry["name"]},
        "traffic": {**load_json(os.path.join(HERE, "traffic", wl["traffic"] + ".json")),
                    "name": wl["traffic"]},
        "limits": load_json(os.path.join(HERE, "limits", workload + ".json")),
    }


def metrics_for(man: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``workload``
    reports: those that list it, and those that list no cells."""
    return [m for m in man[kind] if workload in m.get("workloads", [workload])]


def mpc_params(config_module, config: dict):
    """The configuration's ``MPCParams`` from ``config_module`` (the
    program's ``config`` or the reference's frozen copy): its constructor
    with its overrides."""
    import dataclasses

    cfg = getattr(config_module, config["constructor"])()
    return dataclasses.replace(cfg, **config.get("overrides", {}))


def driver(traffic: dict):
    kind = traffic["driver"]
    return load_module(os.path.join(HERE, "drivers", kind + ".py"), f"bench_driver_{kind}")


def reader(name: str):
    return load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "bench_metric_" + name.replace(".", "_"))


def read_metrics(entries: list[dict], run: dict) -> dict:
    out = {}
    for m in entries:
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def cache_env(root: str = ROOT) -> None:
    """Fixed cache directories inside the checkout for every compiler the
    program or torch may call, before torch is imported."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(base, sub)


def note(obj: dict) -> None:
    """An earlier line of the run's standard output."""
    print(json.dumps(obj), flush=True)


def run(args, device=None, check_device: bool = True, t0=None, traffic_overrides=None,
        config_overrides=None) -> dict:
    """One run of one cell: returns the result object (the last line).

    ``check_device=False`` skips the look for cards: the harness's own
    tests drive a run on ``device`` (the CPU) with the traffic shrunk and
    the CPU's routes matched by ``traffic_overrides`` and
    ``config_overrides``. ``t0`` is when the process started its set-up."""
    t0 = time.perf_counter() if t0 is None else t0
    smi = start_power_limit() if check_device else None
    try:
        return _run(args, device, check_device, t0, traffic_overrides, config_overrides, smi)
    finally:
        if smi is not None and smi.poll() is None:
            smi.kill()
            smi.wait()


def _run(args, device, check_device, t0, traffic_overrides, config_overrides, smi):
    cache_env()
    man = manifest()
    c = cell(man, args.workload)
    c["traffic"].update(traffic_overrides or {})
    c["config"].update(config_overrides or {})
    chips = int(c["workload"]["chips"])
    import torch

    torch.set_num_threads(1)
    if check_device:
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise RunError(f"{torch.cuda.device_count()} cards, the cell needs {chips}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)          # the context, before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    ctx = {"seed": int(args.seed), "seconds": float(args.seconds), "trace": bool(args.trace),
           "device": torch.device(device), "config": c["config"], "traffic": c["traffic"],
           "workload": args.workload, "t0": t0}
    session = driver(c["traffic"]).setup(ctx)
    # the set-up's objects out of the collector's reach: a full collection
    # inside the window then walks what the window made, not every module
    # imported (~0.1 s a walk), which would land on a few periods at random
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    window = session.window(float(args.seconds))
    found = forbidden_modules()
    if found:
        raise RunError(f"forbidden modules loaded once the window closed: {found}")
    traced = None
    if args.trace:
        from . import tracing

        traced = session.traced(tracing.trace)
    counters = session.counters()
    dev_type = ctx["device"].type
    peak = int(torch.cuda.max_memory_allocated(ctx["device"])) if dev_type == "cuda" else 0
    session.release()
    verdict = session.judge(c["limits"])
    watts = power_limit(smi) if smi is not None else None
    run_record = {"setup_s": setup_s, "window": window, "trace": traced, "counters": counters,
                  "config": c["config"], "traffic": c["traffic"], "chips": chips,
                  "power_limit_w": watts}
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = read_metrics(metrics_for(man, args.workload, kind), run_record)
    compared = verdict["compared"]
    correct = (all(v <= lim for v, lim in compared.values()) and verdict["failed"] == 0
               and window["failed"] == 0)
    lines = [{"line": "setup", "seconds": setup_s, **session.setup_parts, "power_limit_w": watts,
              "after_window_s": time.perf_counter() - t0 - setup_s - window["window_s"]},
             {"line": "outcome", **window.get("outcome", {})},
             {"line": "numbers", **verdict["numbers"]}]
    if traced is not None:
        lines.append({"line": "trace", "busy_s": traced["busy_s"], "window_s": traced["window_s"],
                      "profiler_stall_s": traced["stall_s"], "device_events": len(traced["device"]),
                      "ticks": traced["ticks"]})
    for line in lines:
        note(line)
    device_info = {"platform": "gpu" if dev_type == "cuda" else dev_type,
                   "kind": torch.cuda.get_device_name(ctx["device"]) if dev_type == "cuda" else "cpu",
                   "count": chips, "memory_peak_bytes": peak}
    if traced is not None:
        device_info["busy_s"] = traced["busy_s"]
        device_info["window_s"] = traced["window_s"]
    result = {"correct": bool(correct), "attempted": int(window["attempted"]),
              "failed": int(window["failed"] + verdict["failed"]), "metrics": metrics,
              "device": device_info}
    if traced is not None:
        result["breakdown"] = traced["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    found = forbidden_modules()
    if found:
        raise RunError(f"forbidden modules loaded: {found}")
    write_run_file(args, lines + [result])
    return result


def write_run_file(args, lines) -> None:
    """The run's lines, kept in the checkout (``.bench_runs/``, a few KB)."""
    out = os.path.join(ROOT, ".bench_runs")
    os.makedirs(out, exist_ok=True)
    name = f"{args.workload}.s{args.seed}.t{int(args.trace)}.json"
    with open(os.path.join(out, name), "w") as f:
        json.dump(lines, f)


def start_power_limit():
    """``nvidia-smi`` asked for the card's power limit, started now and
    read at the end (``power_limit``), so that it waits on nothing."""
    import subprocess

    try:
        return subprocess.Popen(["nvidia-smi", "--query-gpu=power.limit",
                                 "--format=csv,noheader,nounits"],
                                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def power_limit(proc):
    """The power limit in watts that ``proc`` printed, or None; the process
    has ended when this returns."""
    import subprocess

    try:
        out, _ = proc.communicate(timeout=30)
        return float(out.split()[0])
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return None
    except (ValueError, IndexError):
        return None


def main(argv=None, t0=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="one run of one benchmark cell")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        result = run(args, t0=t0)
    except RunError as err:
        print(f"benchmark: {err}", file=sys.stderr, flush=True)
        return 2
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
