"""python -m nbody_torch.cli --mesh 4 against nbody_tpu's CLI, on the CPU.

The port's runs go through its --mesh entry point (cli.mesh_rank on 4
gloo ranks), all in one spawn (parallel.launch.run_jobs); nbody_tpu's CLI
runs in this process on 4 devices of the 8-device CPU mesh that
tests/conftest.py sets up. Every algorithm, in 2-D and 3-D, in float and
double, on a 128-body galaxy at --group-tile 32 (128 = 4 ranks * 32: no
padding), with --print-state --print-info; the trees in float with
--kernel torch, the port's list paths, which nbody_tpu's CPU runs take.

nbody_tpu's own sharded octree step gives a state that its next step
cannot take on this JAX (a ShardingTypeError in build_octree's
dynamic_update_slice from the second step on; its tests call the step
once), so the octree's runs are held against nbody_tpu's single-device
CLI, which evaluates the same rows when nothing is padded.

Held: every line equal once its numbers are taken out (the times
excepted), and the numbers within 1e-12 (double) or 1e-3 (float, whose
--print-state text carries 4 significant digits) of the largest of their
line; --csv-total rows equal but for the time; --save all and
--save-state files of the same headers and lengths, their values within
the same tolerance; every rank's final state bit-equal to rank 0's
(cli.run_mesh's check, here on each run's digest).
"""

import io
import os
import re

import numpy as np
import pytest
import torch

from nbody_torch import cli as tcli
from nbody_torch.parallel import launch
from nbody_tpu import cli as jcli

torch.set_num_threads(1)

WORLD = 4
NUM = re.compile(r"[-+]?\d+\.\d+e[-+]\d+")
BASE = ["-n", "128", "-s", "12", "--workload", "galaxy", "--group-tile", "32"]
RUNS = {f"{algo}-{dim}d-{prec}": ["-d", str(dim), "--algorithm", algo, "--precision", prec,
                                  "--print-state", "--print-info"]
        for algo in ("all-pairs", "all-pairs-collapsed", "octree", "bvh")
        for dim in (2, 3) for prec in ("float", "double")}
CSV = {f"{algo}-csv": ["-d", "3", "--algorithm", algo, "--csv-total"]
       for algo in ("all-pairs", "octree", "bvh")}
SAVE = ["-d", "3", "--algorithm", "all-pairs", "--precision", "double", "--save", "all",
        "--save-state", "state.bin"]
TOL = {"float": 1e-3, "double": 1e-12}


def _port_argv(argv):
    extra = ["--kernel", "torch"] if "octree" in argv or "bvh" in argv else []
    return [*BASE, *argv, *extra, "--mesh", str(WORLD), "--device", "cpu"]


def _jax_argv(argv):
    return [*BASE, *argv, "--mesh", "1" if "octree" in argv else str(WORLD)]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every run's rank reports (cli.mesh_rank), in one spawn; the --save
    run writes into its own directory."""
    cases = {**RUNS, **CSV, "save": SAVE}
    jobs = [(tcli.mesh_rank, (tcli.parse_args(_port_argv(argv)),)) for argv in cases.values()]
    here, where = os.getcwd(), tmp_path_factory.mktemp("port")
    os.chdir(where)
    try:
        ranks = launch.spawn(WORLD, "cpu", launch.run_jobs, jobs)
    finally:
        os.chdir(here)
    return {name: [r[j] for r in ranks] for j, name in enumerate(cases)}, where


def _jax(argv, cwd, monkeypatch):
    monkeypatch.chdir(cwd)
    out = io.StringIO()
    assert jcli.main(_jax_argv(argv), out=out) == 0
    return out.getvalue()


def _lines(text):
    return [ln for ln in text.splitlines() if not ln.startswith("Total time:")]


def _assert_text(port_text, jax_text, tol):
    t, j = _lines(port_text), _lines(jax_text)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert NUM.sub("#", a) == NUM.sub("#", b), (a, b)
        x, y = (np.array([float(v) for v in NUM.findall(s)]) for s in (a, b))
        if y.size:
            assert np.abs(x - y).max() <= tol * max(np.abs(y).max(), 1e-30), (a, b)


def _reports(port, name):
    reports = port[0][name]
    assert [r["rank"] for r in reports] == list(range(WORLD))
    assert len({r["state_digest"] for r in reports}) == 1
    assert all(r["backend"] == "gloo" and r["device"] == "cpu" for r in reports)
    assert all(r["text"] == "" for r in reports[1:])
    return reports[0]


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_cli_vs_nbody_tpu(name, port, tmp_path, monkeypatch):
    argv = RUNS[name]
    text = _reports(port, name)["text"]
    assert "Final state:" in text
    assert ("Total mass:" in text) == (argv[3] in ("octree", "bvh"))
    _assert_text(text, _jax(argv, tmp_path, monkeypatch), TOL[argv[argv.index("--precision") + 1]])


@pytest.mark.parametrize("name", list(CSV))
def test_mesh_csv_total_vs_nbody_tpu(name, port, tmp_path, monkeypatch):
    t = _reports(port, name)["text"].splitlines()
    j = _jax(CSV[name], tmp_path, monkeypatch).splitlines()
    assert t[0] == j[0] and len(t) == len(j) == 2
    assert t[1].split(",")[:5] == j[1].split(",")[:5]


def test_mesh_saves_like_nbody_tpu(port, tmp_path, monkeypatch):
    """Rank 0 alone writes positions.bin, energy.bin and the state file."""
    _reports(port, "save")
    _jax(SAVE, tmp_path, monkeypatch)
    where = port[1]
    assert sorted(os.listdir(where)) == sorted(os.listdir(tmp_path)) == \
        ["energy.bin", "positions.bin", "state.bin"]
    # the double run's frames are float64; the state file is float32
    for name, head, dtype in (("positions.bin", 16, np.float64), ("energy.bin", 8, np.float64),
                              ("state.bin", 16, np.float32)):
        t, j = (open(os.path.join(d, name), "rb").read() for d in (where, tmp_path))
        assert t[:head] == j[:head] and len(t) == len(j)
        tv, jv = (np.frombuffer(b[head:], dtype) for b in (t, j))
        assert np.abs(tv - jv).max() <= 1e-6 * np.abs(jv).max(), name
