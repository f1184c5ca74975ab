"""The port stands apart from JAX: no module of ``boundplanner_tpu_torch``
and not ``chip_smoke.py`` imports jax, jaxlib or anything of the JAX
package ``boundplanner_tpu`` (the port keeps its own copies of what it
needs, such as ``config`` and ``native_geom``). Every port module imports
with all three blocked. Also
``chip_smoke.py``'s refusal contract: without a CUDA device, or without
the rest of the repository beside it, it exits non-zero and prints no
result on its standard output.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "boundplanner_tpu_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")
BLOCKED = ("jax", "jaxlib", "boundplanner_tpu")


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
    for rel in (("mpc", "bound_mpc.py"), ("idl", "__init__.py"), ("ros_compat.py",),
                ("parallel", "sync_broker.py"), ("examples", "rviz_bringup.py"),
                ("gates.py",)):
        assert os.path.join("boundplanner_tpu_torch", *rel) in names, rel
    assert len(names) > 20


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_only_config_from_jax_package(path):
    for mod in imported_modules(path):
        assert mod.split(".")[0] not in BLOCKED, f"{path} imports {mod}"


def port_modules():
    mods = []
    for path in port_sources():
        rel = os.path.relpath(path, ROOT)
        if rel == "chip_smoke.py":
            continue
        mod = rel[:-3].replace(os.sep, ".")
        mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return mods


@pytest.fixture(scope="module")
def imported_with_jax_blocked():
    """Import every port module in a fresh interpreter whose import system
    refuses jax, jaxlib and the JAX package; returns {module: error or None}."""
    code = (
        "import importlib, importlib.abc, json, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {BLOCKED!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "out = {}\n"
        f"for m in {port_modules()!r}:\n"
        "    try:\n"
        "        importlib.import_module(m); out[m] = None\n"
        "    except Exception as err:\n"
        "        out[m] = repr(err)\n"
        "print(json.dumps(out))\n"
    )
    proc = run_python(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", port_modules())
def test_port_module_imports_with_jax_blocked(imported_with_jax_blocked, module):
    assert imported_with_jax_blocked[module] is None, imported_with_jax_blocked[module]


def run_python(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_importing_the_slice_loads_no_jax():
    code = ("import sys; import boundplanner_tpu_torch.parallel.batch, "
            "boundplanner_tpu_torch.parallel.fleet_cache, "
            "boundplanner_tpu_torch.parallel.fleet, boundplanner_tpu_torch.parallel.broker; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}))")
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
