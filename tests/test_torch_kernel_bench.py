"""python -m nbody_torch.kernel_bench, the port of scripts/kernel_bench.py:
its output on the CPU (through the kernels' plain twins), its inputs
against the JAX script's, its refusal to run without a GPU unless told to
use the CPU, and the seconds-per-step estimator on a stub loop."""

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from nbody_torch import kernel_bench
from nbody_torch.utils.measure import scan_seconds_per_step

ROOT = Path(__file__).resolve().parent.parent
KEYS = {"kernel", "dim", "n", "sec_per_step", "int_per_s"}


def _run(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return subprocess.run([sys.executable, "-m", "nbody_torch.kernel_bench", *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cpu_run_prints_one_line_per_kernel_and_dim():
    kernels = ["torch", "exact", "newton", "fast", "mxu", "mxu-fast"]
    proc = _run("--device", "cpu", "--n", "512", "--dims", "2,3", "--kernels", ",".join(kernels),
                "--repeats", "1")
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert len(rows) == 12
    assert [(r["kernel"], r["dim"]) for r in rows] == [(k, d) for k in kernels for d in (2, 3)]
    for r in rows:
        assert KEYS <= set(r) and r["n"] == 512 and r["device"] == "cpu"
        assert r["sec_per_step"] > 0
        assert r["int_per_s"] == pytest.approx(512 * 511 / r["sec_per_step"])
        assert r["launches"] == {}  # the twins ran, no kernel


def test_inputs_are_the_jax_scripts():
    """scripts/kernel_bench.measure's own m and x, captured through its
    build_loop, equal nbody_torch.kernel_bench.inputs bit for bit."""
    import jax.numpy as jnp

    spec = importlib.util.spec_from_file_location("jax_kernel_bench",
                                                  ROOT / "scripts" / "kernel_bench.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    seen = {}

    def build_loop(kernel_name, m, x, eps):
        seen.update(m=np.asarray(m), x=np.asarray(x), eps=eps)
        return lambda m, x, iters: jnp.sum(x)

    script.build_loop = build_loop
    for dim in (2, 3):
        script.measure("exact", 1000, dim, repeats=1)
        m, x = kernel_bench.inputs(1000, dim)
        assert m.dtype == seen["m"].dtype == np.float32 and x.dtype == seen["x"].dtype
        np.testing.assert_array_equal(m, seen["m"])
        np.testing.assert_array_equal(x, seen["x"])
        assert seen["eps"] == float(np.finfo(np.float32).eps)


def test_without_a_gpu_it_exits_1():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device auto runs on it")
    proc = _run("--n", "64", "--kernels", "exact", "--dims", "2")
    assert proc.returncode == 1 and proc.stdout == ""
    assert "--device cpu" in proc.stderr


def test_unknown_kernel_is_refused():
    proc = _run("--device", "cpu", "--kernels", "jnp")
    assert proc.returncode == 2 and "unknown kernels" in proc.stderr


def test_scan_seconds_per_step_on_a_stub_loop():
    """A loop of 5 ms per step plus a 20 ms fixed cost: the estimator
    returns the step, not the fixed cost; the minimum over repeats and the
    long/short difference as nbody_tpu's (one warm-up, then 3 short and 3
    long runs)."""
    calls = []

    def loop(c, iters):
        calls.append(iters)
        time.sleep(0.020 + 0.005 * iters)
        return c

    dt = scan_seconds_per_step(loop, (None,), torch.device("cpu"), 2, 10, 3)
    assert calls == [2, 2, 2, 2, 10, 10, 10]
    assert 0.004 <= dt <= 0.009
