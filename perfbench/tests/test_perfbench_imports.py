"""Nothing that perfbench runs imports JAX, Flax or the JAX package, compared
by whole top-level module names (the port's name begins with the JAX
package's)."""

import ast
import os
import subprocess
import sys

from perfbench import manifest, run

FORBIDDEN = {"jax", "jaxlib", "flax", "nbody_tpu"}


def test_no_source_of_perfbench_names_a_forbidden_module():
    for src in manifest.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(src.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & FORBIDDEN, (src, tops)


def test_the_reference_imports_nothing_of_the_program():
    for src in (manifest.HERE / "reference").rglob("*.py"):
        assert "nbody_torch" not in src.read_text(), src


def test_a_run_loads_no_forbidden_module(tmp_path):
    """A whole CPU run of a cell in a fresh interpreter, then its modules."""
    code = ("import torch, json\n"
            "from perfbench import run, control\n"
            "run.run_cell('bvh-galaxy3d-1M.f64', 5, 0.2, False, device=torch.device('cpu'),"
            " n=512)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in __import__('sys').modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "nbody_torch" in loaded and not loaded & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlike_pkg", object())
    monkeypatch.setitem(sys.modules, "nbody_tpu_extra", object())
    found = run.forbidden_modules()
    assert "jaxlike_pkg" not in found and "nbody_tpu_extra" not in found
    monkeypatch.setitem(sys.modules, "nbody_tpu.ops", object())
    assert "nbody_tpu.ops" in run.forbidden_modules()
