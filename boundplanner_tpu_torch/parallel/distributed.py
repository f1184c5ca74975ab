"""Fleets sharded over processes (port of
``boundplanner_tpu/parallel/distributed.py`` on ``torch.distributed``).

Every process runs the same program and calls :func:`initialize` first,
which joins a ``torch.distributed`` process group. Each rank owns a
contiguous block of the fleet's scenes (:func:`local_batch_slice`), feeds
only that block onto its own device (:func:`global_from_local`: ``cuda``
device ``rank % device_count`` by default) and rolls it out there; scenes
never communicate, so the only traffic between ranks is the three fleet
diagnostics at the end (:func:`distributed_rollout`): an all-reduce SUM of
counts and sums in float64, and a MAX of the worst attempted violation.

The backend is the caller's choice, never a fallback: ``nccl`` runs one
GPU per rank (NCCL refuses two ranks on one GPU, so :func:`initialize`
raises when there are more ranks than GPUs); ``gloo`` carries the scalars
through host memory, for ranks that share a card or run on the CPU.

Launcher (one command starts N coordinated local processes)::

    python -m boundplanner_tpu_torch.parallel.distributed --nproc 2 -- \\
        python -m boundplanner_tpu_torch.parallel.dryrun --device cuda

Each child inherits ``BOUNDPLANNER_DIST_{COORD,NPROCS,PID}`` and calls
``initialize()`` with no arguments.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Optional, Sequence

import torch
import torch.distributed as tdist

from ..config import MPCParams
from ..mpc.bound_mpc import FleetMPC
from ..utils.device import checked_device
from ..utils.tree import to_numpy, to_torch, tree_map
from .batch import _rollout

ENV_COORD = "BOUNDPLANNER_DIST_COORD"
ENV_NPROCS = "BOUNDPLANNER_DIST_NPROCS"
ENV_PID = "BOUNDPLANNER_DIST_PID"
BACKENDS = ("gloo", "nccl")


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: str = "gloo") -> None:
    """Join the process group (``host:port`` of rank 0's store). The
    arguments default to the ``BOUNDPLANNER_DIST_*`` variables that
    :func:`launch` sets."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    coordinator_address = coordinator_address or os.environ[ENV_COORD]
    num_processes = int(os.environ[ENV_NPROCS]) if num_processes is None else num_processes
    process_id = int(os.environ[ENV_PID]) if process_id is None else process_id
    if backend == "nccl":
        checked_device("cuda")
        if num_processes > torch.cuda.device_count():
            raise ValueError(f"nccl runs one GPU per rank: {num_processes} ranks, "
                             f"{torch.cuda.device_count()} GPUs; use backend='gloo'")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    tdist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                             world_size=num_processes, rank=process_id)


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def process_count() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if is_initialized() else 0


def local_device():
    """This rank's card: CUDA device ``rank % device_count`` (raises at
    once without one)."""
    checked_device("cuda")
    return torch.device("cuda", process_index() % torch.cuda.device_count())


def global_scenario_mesh(device=None) -> list:
    """The scenario axis over every rank's device, in rank order: rank r
    feeds CUDA device ``r % device_count`` (:func:`local_device`), or
    ``device`` on every rank (for example ``"cpu"``). Without a process
    group, this process's device alone."""
    if device is None:
        checked_device("cuda")
        count = torch.cuda.device_count()
        return [torch.device("cuda", r % count) for r in range(process_count())]
    return [checked_device(device)] * process_count()


def local_batch_slice(global_batch: int) -> slice:
    """The contiguous block of the global scene axis this rank feeds
    (``global_batch / process_count`` scenes)."""
    nproc = process_count()
    if global_batch % nproc:
        raise ValueError(f"global batch {global_batch} not divisible by {nproc} processes")
    per = global_batch // nproc
    pid = process_index()
    return slice(pid * per, (pid + 1) * per)


def global_from_local(tree_local, device, dtype=torch.float32):
    """This rank's shard of the fleet on its device (``device``, or this
    rank's entry of a :func:`global_scenario_mesh`): numpy leaves become
    tensors (floating ones in ``dtype``), tensor leaves move. Scenes never
    cross ranks, so this is all the global layout asks for."""
    if isinstance(device, list):
        device = device[process_index()]
    device = checked_device(device)
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                    else to_torch(x, device, dtype), tree_local)


def local_from_global(tree):
    """This rank's shard back on the host, as numpy."""
    return to_numpy(tree)


def all_reduce(values, op):
    """``values`` (floats) reduced with ``op`` (``torch.distributed.ReduceOp``)
    over every rank, in float64: through host memory under gloo, on this
    rank's card under nccl. Without a process group, the values."""
    t = torch.tensor(values, dtype=torch.float64)
    if is_initialized():
        t = t.to("cpu" if tdist.get_backend() == "gloo" else local_device())
        tdist.all_reduce(t, op=op)
    return t.cpu().tolist()


def reduce_diagnostics(recs) -> dict:
    """The fleet diagnostics over every rank's records: success share and
    mean final phi from float64 sums all-reduced with SUM, the worst
    attempted violation with MAX. Equal on every rank."""
    success = recs["success"].double()
    phi_final = recs["phi"][:, -1].double()
    n_ok, n_ticks, phi_sum, n_scenes = all_reduce(
        [float(success.sum()), success.numel(), float(phi_final.sum()), phi_final.numel()],
        tdist.ReduceOp.SUM)
    (worst,) = all_reduce([float(recs["viol"].max())], tdist.ReduceOp.MAX)
    return {"success_rate": n_ok / n_ticks, "max_viol": worst,
            "mean_phi_final": phi_sum / n_scenes}


def distributed_rollout(carry_local, q0_local, obs_local, cfg: MPCParams, n_ticks: int,
                        device=None, dtype=torch.float32):
    """Closed-loop rollout of this rank's scenes on its device, with no
    escalation retry whatever ``cfg.esc_lanes`` says (JAX's rollout here is
    ``vmap`` of ``closed_loop_rollout``).

    Inputs are this rank's scenes only (numpy or tensors; the leading axis
    is the local count, equal on every rank). ``device`` defaults to the
    card :func:`local_device` gives. Returns ``(final_local, recs_local,
    diag)``: the first two as host numpy of this rank's scenes, ``diag``
    the fleet-wide reductions of :func:`reduce_diagnostics`, equal on
    every rank."""
    device = local_device() if device is None else checked_device(device)
    carry, q0, obs = global_from_local((carry_local, q0_local, obs_local), device, dtype)
    model = FleetMPC(cfg, device=device, dtype=dtype)
    final, recs = _rollout(carry, q0, obs, model, n_ticks, escalate=False)
    diag = reduce_diagnostics(recs)
    return local_from_global(final), local_from_global(recs), diag


# ----------------------------------------------------------------------
# launcher


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(cmd: Sequence[str], nproc: int, env_extra: Optional[dict] = None,
           timeout: Optional[float] = None) -> list:
    """Start ``nproc`` copies of ``cmd`` wired to one coordinator on a
    fresh local port and wait for all (each for at most ``timeout``
    seconds). Returns [(returncode, output)] in rank order; raises if any
    failed or timed out, after stopping every process still running."""
    coord = f"localhost:{free_port()}"
    procs = []
    try:
        for pid in range(nproc):
            env = dict(os.environ)
            env.update(env_extra or {})
            env.update({ENV_COORD: coord, ENV_NPROCS: str(nproc), ENV_PID: str(pid)})
            procs.append(subprocess.Popen(list(cmd), env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        results = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += f"\n(killed after {timeout} s)"
            results.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(pid, out) for pid, (rc, out) in enumerate(results) if rc != 0]
    if failed:
        msgs = "\n".join(f"--- process {pid} ---\n{out}" for pid, out in failed)
        raise RuntimeError(f"{len(failed)}/{nproc} processes failed:\n{msgs}")
    return results


def _main(argv):
    import argparse

    ap = argparse.ArgumentParser(description="Start N coordinated processes of a fleet program.")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("cmd", nargs=argparse.REMAINDER, help="command to run (after --)")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given")
    for _, out in launch(cmd, args.nproc, timeout=args.timeout):
        sys.stdout.write(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main(sys.argv[1:]))
