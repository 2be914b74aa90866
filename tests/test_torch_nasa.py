"""python -m nbody_torch.probe nasa (nbody_torch/probes/nasa.py), the port of
scripts/nasa.py, against the script run on nbody_tpu on the CPU:

* the synthetic CSV and the converted .bin byte-equal to the script's
  make_synthetic_csv and conv_csv.convert (also at prop 0.5, and a CSV
  with NaN rows and coincident positions, converted in a fresh process);
* at 150 bodies and 3 steps, each engine's positions.bin against the
  script's: the header and first frame byte-equal, the later frames
  within POS_TOL of each coordinate column's largest |value| (the float64
  all-pairs and list sums add in other orders than XLA's);
* the printed octree vs all-pairs lines, per body under 1e-10 as
  tests/test_tooling.py requires of the script;
* check_state's L1 lines against the script's on the same files.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nbody_torch import probe
from nbody_torch.probes import nasa

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
POS_TOL = 1e-12


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    sys.path.insert(0, str(SCRIPTS))  # nasa.py and check_state.py import their siblings
    try:
        yield {name: _load(name) for name in ("nasa", "conv_csv", "check_state")}
    finally:
        sys.path.remove(str(SCRIPTS))


@pytest.mark.parametrize("n", [2, 150, 2000])
def test_synthetic_csv_and_bin_byte_equal(scripts, tmp_path, n, capsys):
    nasa.make_synthetic_csv(str(tmp_path / "ours.csv"), n)
    scripts["nasa"].make_synthetic_csv(str(tmp_path / "ref.csv"), n)
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()
    for prop in (1.0, 0.5):
        ours = nasa.convert(str(tmp_path / "ours.csv"), str(tmp_path / "ours.bin"), prop)
        ref = scripts["conv_csv"].convert(str(tmp_path / "ours.csv"), str(tmp_path / "ref.bin"),
                                          prop)
        assert ours == ref
        assert (tmp_path / "ours.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()
    assert float(nasa.gravitational_constant_au_day()) == float(
        scripts["conv_csv"].gravitational_constant_au_day())


def test_convert_nan_rows_and_duplicates_in_fresh_processes(tmp_path):
    """Rows with a NaN become massless bodies at a random x: the port's own
    Random(42) gives the bytes that a fresh process running the script's
    convert (random seeded at import) gives; coincident positions move."""
    rows = ["id,name,class,mass,x,y,z,vx,vy,vz",
            "0,Sun,STA,1e30,0,0,0,0,0,0",
            "1,a,MBA,1e10,2.5,0.1,0.0,0.001,0.01,0",
            "2,b,MBA,nan,2.5,0.1,0.0,0.001,0.01,0",
            "3,c,MBA,1e11,2.5,0.1,0.0,0,0,0",
            "4,d,MBA,1e12,nan,1,1,0,0,0",
            "5,e,MBA,1e12,2.5,0.1,0.0,0,0,0"]
    src = tmp_path / "in.csv"
    src.write_text("\n".join(rows) + "\n")
    outs = {}
    for tag, code in (("ours", "from nbody_torch.probes.nasa import convert"),
                      ("ref", f"import sys; sys.path.insert(0, {str(SCRIPTS)!r}); "
                              "from conv_csv import convert")):
        path = tmp_path / f"{tag}.bin"
        proc = subprocess.run([sys.executable, "-c", f"{code}; convert({str(src)!r}, "
                               f"{str(path)!r})"], cwd=ROOT, capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": str(ROOT)}, timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs[tag] = (proc.stdout, path.read_bytes())
    assert outs["ours"] == outs["ref"]
    assert "Replaced 2 NaN bodies" in outs["ours"][0] and "Adjusted 6 bodies" in outs["ours"][0]


@pytest.fixture(scope="module")
def runs(scripts, tmp_path_factory):
    """The script's pipeline on nbody_tpu and the port's through probe.main,
    at 150 synthetic bodies and 3 steps."""
    import contextlib
    import io

    tmp = tmp_path_factory.mktemp("nasa")
    printed = {}
    for tag, call in (("ref", lambda w: scripts["nasa"].main(
                                ["--synthetic", "150", "--steps", "3", "--workdir", w])),
                      ("ours", lambda w: probe.main(
                                ["nasa", "--synthetic", "150", "--steps", "3", "--workdir", w,
                                 "--device", "cpu"]))):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert call(str(tmp / tag)) == 0
        printed[tag] = (out.getvalue(), err.getvalue())
    return tmp, printed


@pytest.mark.parametrize("engine", ["octree", "all_pairs"])
def test_positions_match_script(runs, engine):
    tmp, _ = runs
    ours = (tmp / "ours" / engine / "positions.bin").read_bytes()
    ref = (tmp / "ref" / engine / "positions.bin").read_bytes()
    assert len(ours) == len(ref)
    header = np.frombuffer(ref[:16], np.uint32)
    assert ours[:16] == ref[:16] and list(header) == [150, 3, 8, 3]
    frame = 16 + 150 * 3 * 8
    assert ours[16:frame] == ref[16:frame]  # the loaded start
    a = np.frombuffer(ours[16:], np.float64).reshape(-1, 150, 3)
    b = np.frombuffer(ref[16:], np.float64).reshape(-1, 150, 3)
    assert a.shape[0] == 4  # --csv-detailed: the start and one frame a step
    assert np.all(np.abs(a - b) <= POS_TOL * np.abs(b).max(axis=1, keepdims=True))


def test_printed_lines(runs):
    tmp, printed = runs
    (ours, err), (ref, _) = printed["ours"], printed["ref"]
    for text in (ours, ref):
        lines = text.splitlines()
        i = lines.index("# octree vs all-pairs final positions:")
        assert lines[i + 1].startswith("Total absolute difference is ")
        assert lines[i + 2].startswith("Absolute difference per body is ")
        assert float(lines[i + 2].split()[-1]) < 1e-10

    def steps(text, tag):  # the pipeline's own lines, its work directory named W
        return [line.replace(str(tmp / tag), "W") for line in text.splitlines()
                if line.startswith(("# ", "Saved", "Total mass", "Replaced", "Adjusted"))]

    assert steps(ours, "ours") == steps(ref, "ref")
    assert len(steps(ours, "ours")) == 8
    assert "# reference oracle unavailable: no reference source given" in err


def test_check_state_lines_match_script(runs, scripts, capsys):
    tmp, _ = runs
    files = [str(tmp / "ours" / "octree" / "positions.bin"),
             str(tmp / "ref" / "all_pairs" / "positions.bin")]
    csv_path = tmp / "last.csv"
    last = nasa.read_points(files[1])[-1].T
    csv_path.write_text("x,y,z\n" + "".join(",".join(repr(float(v)) for v in r) + "\n"
                                             for r in last))
    for pair in ((files[0], files[1]), (files[0], str(csv_path))):
        nasa.check_state(*pair)
        ours = capsys.readouterr().out
        scripts["check_state"].main(list(pair))
        assert ours == capsys.readouterr().out


def test_reference_helpers(runs, tmp_path):
    """The reference binary's availability says why it is not, and
    read_positions reads every frame a run wrote (read_points caps them at
    the header's nsteps)."""
    from nbody_torch.probes import reference

    assert reference.reference_problem(None).startswith("no reference source given")
    missing = str(tmp_path / "main.cpp")
    assert reference.reference_problem(missing) == f"the reference source {missing} does not exist"
    assert not reference.reference_available(missing)
    tmp, _ = runs
    path = str(tmp / "ours" / "octree" / "positions.bin")
    frames = reference.read_positions(path)
    assert frames.shape == (4, 150, 3) and frames.dtype == np.float64
    assert np.array_equal(frames[:3], nasa.read_points(path).transpose(0, 2, 1))
