"""The port stands alone: ``pfilter_tpu_torch`` (its KITTI runner
``run_kitti.py`` included) and ``chip_smoke.py`` import neither JAX, nor the
reference package, nor the reference's ``tools/``, checked two ways — by walking their
import statements, and by importing every module in a fresh interpreter in
which ``jax``, ``jaxlib`` and ``pfilter_tpu`` cannot be imported."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "pfilter_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "pfilter_tpu", "tools")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_every_module_imports_without_jax():
    code = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib, pkgutil
sys.path.insert(0, {str(ROOT)!r})
import pfilter_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pfilter_tpu_torch.__path__, "pfilter_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r} and sys.modules[m] is not None)
assert not loaded, loaded
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    # Every module of the ES and BPF slices and of the KITTI runner's slice was imported.
    assert int(out.stdout.strip().splitlines()[-1]) >= 30


def test_runner_is_covered():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in ("run_kitti.py", "models/global_map.py", "utils/checkpoint.py", "utils/kitti.py", "utils/profiling.py"):
        assert f"pfilter_tpu_torch/{mod}" in names


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA card the smoke script exits non-zero and prints no
    result line (any card is hidden from the child process)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True, text=True, cwd=tmp_path, timeout=300, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
