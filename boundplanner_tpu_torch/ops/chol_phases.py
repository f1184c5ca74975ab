"""Where kernel A's time goes, phase by phase (a design probe, not used by
the port).

Run on a machine with an NVIDIA GPU and ``nvcc``, from the repository root:

    python -m boundplanner_tpu_torch.ops.chol_phases [SOURCE]

It copies kernel A's source (``csrc/chol_inverse.cu`` unless SOURCE is
given), has every warp of block 0 record ``clock64()`` (SM cycles) where
each phase of each panel ends, builds the copy into its own library
under ``_build/`` and launches it three times at the main path's shapes,
(128, 136, 136) f32 and (2, 136, 136) f64. It prints one JSON line per
shape: the cycles from the kernel's start to the end of the load, and per
panel the cycles from the panel's start to where its slowest warp ends
each phase (A: the diagonal block read; rowsolve: the panel below it;
barrier1: the row block staged and the first barrier passed; B0: the
lookahead warp's factor of the next block; B1: the inverse's block row;
B2: the trailing update, before the second barrier), with the card's
name, power limit and highest SM clock.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

from ._build import BUILD_DIR, NVCC_FLAGS, SRC_DIR, _nvcc

SLOTS = 2048
# phase -> (marker in the source, record after (True) or before it)
MARKS = {
    "A": ("    // the panel below the diagonal block", False),
    "rowsolve": ("    // stage L row block", False),
    "barrier1": ("    // ---- B0.", False),
    "B0": ("    // ---- B1.", False),
    "B1": ("    // ---- B2.", False),
    "B2": ("    __syncthreads();\n  }\n\n  // ---- store", False),
}
PANEL_START = "    const int k1 = k0 + kb;\n"
LOAD_START = "  // ---- load K's lower triangle"
LOAD_END = "  // the first diagonal block"


def instrument(src: str) -> str:
    """The source with clock64 records: slot (panel * 8 + phase) * 8 + warp."""
    def rec(slot):
        return ("    if (blockIdx.x == 0 && lane == 0) "
                f"bp_clock[{slot} + warp] = clock64();\n")

    def put(text, marker, code, after):
        if text.count(marker) != 1:
            raise ValueError(f"marker not found once in the source: {marker!r}")
        return text.replace(marker, marker + code if after else code + marker)

    text = put(src, "namespace {\n", f"__device__ long long bp_clock[{SLOTS}];\n", True)
    text = put(text, LOAD_START, rec(SLOTS - 32), False)
    text = put(text, LOAD_END, rec(SLOTS - 24), False)
    text = put(text, PANEL_START, rec("(k0 >> 3) * 64"), True)
    for phase, (marker, after) in MARKS.items():
        slot = f"((k0 >> 3) * 8 + {list(MARKS).index(phase) + 1}) * 8"
        text = put(text, marker, rec(slot), after)
    read = f"cudaMemcpyFromSymbol(h, bp_clock, {SLOTS} * 8)"
    return text + ('\nextern "C" int bp_clock_read(long long* h) {\n'
                   f"  return static_cast<int>({read});\n}}\n")


def build(src_path: str) -> ctypes.CDLL:
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, "chol_phases.cu")
    so = os.path.join(BUILD_DIR, "chol_phases.so")
    with open(src_path) as f, open(cu, "w") as out:
        out.write(instrument(f.read()))
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_nvcc(), *flags, "-shared", "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    for name in ("bp_chol_inverse_f32", "bp_chol_inverse_f64"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
    return lib


def spd(rng, bsz, n):
    import numpy as np

    g = rng.normal(size=(bsz, 400, n)) / 20.0
    w = 10.0 ** rng.uniform(-2.0, 2.0, size=(bsz, 400))
    return np.einsum("bmi,bm,bmj->bij", g, w, g) + 1e-2 * np.eye(n)


def phases(lib, bsz, n, dtype):
    import numpy as np
    import torch

    k = torch.from_numpy(spd(np.random.default_rng(0), bsz, n)).to("cuda", dtype)
    out = torch.empty_like(k)
    entry = lib.bp_chol_inverse_f32 if dtype == torch.float32 else lib.bp_chol_inverse_f64
    for _ in range(3):
        err = entry(k.data_ptr(), out.data_ptr(), bsz, n, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * SLOTS)()
    if lib.bp_clock_read(buf):
        raise RuntimeError("reading the clock records failed")
    rec = np.array(buf[:], dtype=np.int64)
    t0 = rec[SLOTS - 32:SLOTS - 24].min()
    panels = []
    for p in range((n + 7) // 8):
        block = rec[p * 64:(p + 1) * 64].reshape(8, 8)          # slot, warp
        start = block[0].min()
        panels.append({"panel": p, "start": int(start - t0),
                       **{ph: int(block[i + 1].max() - start) for i, ph in enumerate(MARKS)}})
    return {"shape": [bsz, n, n], "dtype": str(dtype).split(".")[-1],
            "load_cycles": int(rec[SLOTS - 24:SLOTS - 16].max() - t0),
            "panels": panels}


def main(argv):
    import torch

    src = argv[0] if argv else os.path.join(SRC_DIR, "chol_inverse.cu")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = build(src)
    for bsz, dtype in ((128, torch.float32), (2, torch.float64)):
        print(json.dumps({"card": card, **phases(lib, bsz, 136, dtype)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
