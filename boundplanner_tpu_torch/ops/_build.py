"""Build and load the hand-written CUDA kernels of ``csrc/`` (kernels A,
B and C: ``chol_inverse.cu``, ``line_polytope.cu``, ``kkt_gram.cu``), with
``csrc/graph_cond.cu``'s graph helpers: the conditional graph node
(`mpc.graph.device_cond`) and the tick's phase marks
(`telemetry.device_phase`).

``nvcc`` compiles every ``csrc/*.cu`` (one ``nvcc`` per source, all
started together) and links the objects into one shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers: the build
takes seconds). The library lands in ``boundplanner_tpu_torch/_build/``
(listed in ``.gitignore``), named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one is reused. Nothing is built at import:
the first kernel launch calls :func:`library`. Building and loading hold a
lock, so concurrent first launches from several threads (the planner's
fleet builder) build and load the library once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared", "-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong
_SIGNATURES = {
    "bp_chol_inverse_f32": (_P, _P, _I, _I, _P),
    "bp_chol_inverse_f64": (_P, _P, _I, _I, _P),
    "bp_line_polytope_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "bp_kkt_gram_f64": (_P, _P, _P, _D, _P, _P, _L, _L, _L, _I, _I, _I, _I, _I, _P),
    "bp_graph_add_if": (_P, _P, _P),
    "bp_phase_mark": (_P, _I),
}


def _sources():
    return sorted(
        os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libbp_kernels_{h.hexdigest()[:16]}.so")


_LOCK = threading.RLock()
_LIB = None


def build() -> tuple[str, float]:
    """Compile the kernels if the library for these sources is missing.
    Returns (library path, seconds spent compiling; 0.0 when reused). The
    compiler's register/shared-memory report goes to ``<library>.log``."""
    with _LOCK:
        return _build_locked()


def _build_locked() -> tuple[str, float]:
    out = library_path()
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR, prefix=".obj-") as obj_dir:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o",
                 os.path.join(obj_dir, os.path.basename(src) + ".o"), src]
                for src in _sources() if src.endswith(".cu")]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        outputs = [proc.communicate() for proc in procs]
        steps = [(cmd, proc.returncode, o + e) for cmd, proc, (o, e) in zip(cmds, procs, outputs)]
        if all(rc == 0 for _, rc, _ in steps):
            link = [nvcc, *LINK_FLAGS, "-o", tmp, *(cmd[-2] for cmd in cmds)]
            proc = subprocess.run(link, capture_output=True, text=True)
            steps.append((link, proc.returncode, proc.stdout + proc.stderr))
    seconds = time.perf_counter() - t0
    with open(out + ".log", "w") as f:
        f.writelines(" ".join(cmd) + "\n" + text for cmd, _, text in steps)
    failed = [(cmd, rc, text) for cmd, rc, text in steps if rc != 0]
    if failed:
        cmd, rc, text = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library (built and loaded once, on first call)."""
    global _LIB
    lib = _LIB
    if lib is not None:
        return lib
    with _LOCK:
        if _LIB is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
