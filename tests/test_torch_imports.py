"""The port stands apart from JAX: no module of ``boundplanner_tpu_torch``
and not ``chip_smoke.py`` imports jax, and the only module of the JAX
package they import is the numpy-only ``boundplanner_tpu.config``. Also
``chip_smoke.py``'s refusal contract: without a CUDA device, or without
the rest of the repository beside it, it exits non-zero and prints no
result on its standard output.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "boundplanner_tpu_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def port_sources():
    files = [SMOKE]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_found():
    names = {os.path.relpath(p, ROOT) for p in port_sources()}
    assert "chip_smoke.py" in names
    assert os.path.join("boundplanner_tpu_torch", "mpc", "bound_mpc.py") in names
    assert len(names) > 20


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_only_config_from_jax_package(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path} imports {mod}"
        if top == "boundplanner_tpu":
            assert mod == "boundplanner_tpu.config", f"{path} imports {mod}"


def run_python(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_importing_the_slice_loads_no_jax():
    code = ("import sys; import boundplanner_tpu_torch.parallel.batch, "
            "boundplanner_tpu_torch.parallel.fleet_cache; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')))")
    proc = run_python(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_chip_smoke_refuses_without_cuda():
    proc = run_python([SMOKE], ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_chip_smoke_refuses_alone(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    proc = run_python(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""
