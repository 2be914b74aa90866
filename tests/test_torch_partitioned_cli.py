"""python -m nbody_torch.cli --mesh N --mesh-layout partitioned [--mesh-tile
T] against nbody_tpu's CLI, on the CPU.

The port's runs go through its --mesh entry point (cli.mesh_rank on 4
gloo ranks: --mesh 4, or --mesh 2 --mesh-tile 2), all in one spawn
(parallel.launch.run_jobs); nbody_tpu's CLI runs in this process on the
8-device CPU mesh that tests/conftest.py sets up. Galaxies, octree and
bvh:

* --print-state --print-info at n = 1,024 (no body padded: nbody_tpu's
  per-step loop cannot pad a state that carries its mesh's sharding, the
  ShardingTypeError of ROADMAP Queue 3), 2-D and 3-D, float and double:
  every line equal once its numbers are taken out, the numbers within
  1e-3 (float, whose --print-state text carries 4 significant digits) or
  1e-9 (double) of the largest of their line;
* -n 512 -s 2 --save-state (the acceptance runs, pads and all), both
  meshes: the state files of one header and length, every column within
  1e-5 of its largest value (float32 after 12 steps), the masses equal;
* -n 512 -s 12 --csv-total: the rows equal but for the time;
* every rank ends with the same gathered state (cli.run_mesh's check,
  here on each run's digest), and a partitioned bvh on 3 ranks fails
  before any rank starts, with nbody_tpu's ValueError.
"""

import io
import os
import re
import struct

import numpy as np
import pytest
import torch

from nbody_torch import cli as tcli
from nbody_torch.parallel import launch
from nbody_tpu import cli as jcli

torch.set_num_threads(1)

WORLD = 4
NUM = re.compile(r"[-+]?\d+\.\d+(?:e[-+]\d+)?")
MESHES = {"mesh4": ["--mesh", "4"], "mesh2x2": ["--mesh", "2", "--mesh-tile", "2"]}
LAYOUT = ["--workload", "galaxy", "--mesh-layout", "partitioned"]
RUNS = {"octree-2d-float-mesh4": ("octree", 2, "float", "mesh4"),
        "bvh-2d-float-mesh2x2": ("bvh", 2, "float", "mesh2x2"),
        "octree-3d-double-mesh2x2": ("octree", 3, "double", "mesh2x2"),
        "bvh-3d-float-mesh4": ("bvh", 3, "float", "mesh4")}
SAVES = {f"{algo}-{mesh}": (algo, mesh) for algo in ("octree", "bvh") for mesh in MESHES}
CSV = ("octree", "bvh")
TOL = {"float": 1e-3, "double": 1e-9}
STATE_TOL = 1e-5


def _run_argv(algo, dim, prec, mesh):
    return ["-n", "1024", "-s", "2", "-d", str(dim), "--algorithm", algo, "--precision", prec,
            *LAYOUT, *MESHES[mesh], "--print-state", "--print-info"]


def _save_argv(algo, mesh):
    return ["-n", "512", "-s", "2", "--algorithm", algo, *LAYOUT, *MESHES[mesh],
            "--save-state", f"{algo}-{mesh}.bin"]


def _csv_argv(algo):
    return ["-n", "512", "-s", "12", "-d", "3", "--algorithm", algo, *LAYOUT, *MESHES["mesh4"],
            "--csv-total"]


def _cases():
    return {**{f"run-{k}": _run_argv(*v) for k, v in RUNS.items()},
            **{f"save-{k}": _save_argv(*v) for k, v in SAVES.items()},
            **{f"csv-{a}": _csv_argv(a) for a in CSV}}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every run's rank reports (cli.mesh_rank), in one spawn, in a
    directory of their own."""
    cases = _cases()
    jobs = [(tcli.mesh_rank, (tcli.parse_args([*argv, "--device", "cpu"]),))
            for argv in cases.values()]
    here, where = os.getcwd(), tmp_path_factory.mktemp("port")
    os.chdir(where)
    try:
        ranks = launch.spawn(WORLD, "cpu", launch.run_jobs, jobs)
    finally:
        os.chdir(here)
    return {name: [r[j] for r in ranks] for j, name in enumerate(cases)}, where


def _reports(port, name):
    reports = port[0][name]
    assert [r["rank"] for r in reports] == list(range(WORLD))
    assert len({r["state_digest"] for r in reports}) == 1
    assert all(r["backend"] == "gloo" and r["device"] == "cpu" for r in reports)
    assert all(r["text"] == "" for r in reports[1:])
    return reports[0]


def _jax(argv, cwd, monkeypatch):
    monkeypatch.chdir(cwd)
    out = io.StringIO()
    assert jcli.main(argv, out=out) == 0
    return out.getvalue()


def _lines(text):
    return [ln for ln in text.splitlines() if not ln.startswith("Total time:")]


def _state(path):
    with open(path, "rb") as f:
        head = f.read(16)
        n, dim = struct.unpack("<II", head[:8])
        return head, np.frombuffer(f.read(), np.float32).reshape(n, 1 + 2 * dim)


@pytest.mark.parametrize("name", list(RUNS))
def test_partitioned_cli_text_vs_nbody_tpu(name, port, tmp_path, monkeypatch):
    algo, dim, prec, mesh = RUNS[name]
    text = _reports(port, f"run-{name}")["text"]
    assert "Final state:" in text and "Total mass:" in text
    t, j = _lines(text), _lines(_jax(_run_argv(algo, dim, prec, mesh), tmp_path, monkeypatch))
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert NUM.sub("#", a) == NUM.sub("#", b), (a, b)
        x, y = (np.array([float(v) for v in NUM.findall(s)]) for s in (a, b))
        if y.size:
            assert np.abs(x - y).max() <= TOL[prec] * max(np.abs(y).max(), 1e-30), (a, b)


@pytest.mark.parametrize("name", list(SAVES))
def test_partitioned_cli_state_vs_nbody_tpu(name, port, tmp_path, monkeypatch):
    algo, mesh = SAVES[name]
    _reports(port, f"save-{name}")
    _jax(_save_argv(algo, mesh), tmp_path, monkeypatch)
    (th, tv), (jh, jv) = (_state(os.path.join(d, f"{name}.bin")) for d in (port[1], tmp_path))
    assert th == jh and tv.shape == jv.shape == (512, 5)
    np.testing.assert_array_equal(tv[:, 0], jv[:, 0])
    assert (np.abs(tv - jv).max(0) <= STATE_TOL * np.abs(jv).max(0)).all()


@pytest.mark.parametrize("algo", CSV)
def test_partitioned_cli_csv_vs_nbody_tpu(algo, port, tmp_path, monkeypatch):
    t = _reports(port, f"csv-{algo}")["text"].splitlines()
    j = _jax(_csv_argv(algo), tmp_path, monkeypatch).splitlines()
    assert t[0] == j[0] and len(t) == len(j) == 2
    assert t[1].split(",")[:5] == j[1].split(",")[:5] == [algo, "3", "32", "2", "512"]


def test_partitioned_bvh_on_3_ranks_fails_like_nbody_tpu():
    argv = ["-n", "64", "--algorithm", "bvh", "--mesh", "3", "--mesh-layout", "partitioned"]
    with pytest.raises(ValueError) as jerr:
        jcli.main(argv, out=io.StringIO())
    with pytest.raises(ValueError) as err:
        tcli.main([*argv, "--device", "cpu"], out=io.StringIO())
    assert str(err.value) == str(jerr.value)
    assert "power-of-two" in str(err.value)


def test_help_names_the_partitioned_layout(capsys):
    with pytest.raises(SystemExit):
        tcli.parse_args(["--help"])
    text = capsys.readouterr().out
    assert "not yet ported" not in text and "--mesh-tile T" in text and "partitioned" in text
    assert tcli.mesh_world(tcli.parse_args(["--algorithm", "bvh", *MESHES["mesh2x2"], *LAYOUT])) \
        == 4
    assert tcli.mesh_world(tcli.parse_args(["--algorithm", "all-pairs", *MESHES["mesh2x2"],
                                            *LAYOUT])) == 2
