"""The accuracy study's pre-roll and trajectory modes and the growth probe
(nbody_torch/probes/accuracy.py: python -m nbody_torch.probe accuracy and
acc-growth), against scripts/accuracy_study.py's functions and
scripts/probe_acc_growth.py's loop, rebuilt here, on nbody_tpu on the CPU
(its float32 fast paths in Pallas interpret mode). The scripts' main()
and preroll_state write into the repo's results/ and are not called.

Held, at n = 2,048 on the 2-D galaxy (3-D for growth):
* a 3-step pre-roll (preroll_state) against the same steps through the
  script's _make_step(..., fast=True): m equal, x and v within 1e-6 and a,
  ao within 1e-5 of the field's sum |value| (interpret mode's reciprocal);
  cached beside the output and read back equal;
* the trajectory rows over 3 steps, with and without the all-pairs oracle,
  against the rows rebuilt from the script's evolve_ours: the same keys;
  the float64 column within 1e-6 relative; the float32 columns (the legs'
  gap, elementwise and canonical) under 1e-6 on both sides, and fp32fast_vs_oracle within that gap of
  f64group_vs_oracle on both sides (the triangle inequality); the evolved
  mode from a pre-roll, with no reference keys;
* two growth steps per tree: the same rows and steps as the script's loop,
  pos_l1 under 1e-6 and acc_l1 under 1e-5 on both sides, the JSON lines
  appended to --out.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from nbody_torch import probe
from nbody_torch.probes import accuracy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
N = 2048
FIELD_TOL = {"x": 1e-6, "v": 1e-6, "a": 1e-5, "ao": 1e-5}
GAP = 1e-6  # the float32 legs' final-position gap at 3 steps, either side
GROWTH_BOUND = {"pos_l1": 1e-6, "acc_l1": 1e-5}


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("accuracy_study",
                                                  ROOT / "scripts" / "accuracy_study.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module._jax_setup()
    return module


def test_preroll_matches_script_steps(script, tmp_path):
    from nbody_tpu.models import build_galaxy_model

    cfg, s = build_galaxy_model(N, 2, np.float32)
    cfg = cfg.replace(theta=script.THETA)
    step = script._make_step("octree", cfg, np.float32, fast=True)
    for k in range(3):
        s, _ = step(s, k)
    ours = accuracy.preroll_state(N, 2, 3, str(tmp_path), CPU)
    assert np.array_equal(ours["m"], np.asarray(s.m))
    for f, tol in FIELD_TOL.items():
        ref = np.asarray(getattr(s, f), np.float64)
        assert ours[f].dtype == np.float32
        assert np.abs(ours[f] - ref).sum() <= tol * np.abs(ref).sum(), f
    cached = accuracy.preroll_state(N, 2, 3, str(tmp_path), CPU)
    assert (tmp_path / f"preroll_{N}_2d_3.npz").exists()
    assert all(np.array_equal(cached[f], ours[f]) for f in accuracy.FIELDS)


def _script_row(script, algo, ap_oracle):
    j64, _ = script.evolve_ours(algo, N, 2, np.float64, 3, script.THETA, False)
    j32, _ = script.evolve_ours(algo, N, 2, np.float32, 3, script.THETA, True)
    row = {"dim": 2, "algo": algo, "n": N, "steps": 3, "theta": script.THETA,
           "evolved": False}
    if not ap_oracle:
        scale = float(np.abs(j64).sum())
        row["ours_fp32fast_vs_f64group"] = float(np.abs(j32 - j64).sum()) / scale
        row["ours_fp32fast_vs_f64group_canon"] = script._canon_l1(j32, j64) / scale
        return row
    xo, _ = script.evolve_ours("all-pairs", N, 2, np.float64, 3, 0.0, False)
    scale = float(np.abs(xo).sum())
    row["ours_fp32fast_vs_f64group"] = float(np.abs(j32 - j64).sum()) / scale
    row["ours_fp32fast_vs_f64group_canon"] = script._canon_l1(j32, j64) / scale
    row["ours_fp32fast_vs_oracle"] = float(np.abs(j32 - xo).sum()) / scale
    row["ours_f64group_vs_oracle"] = float(np.abs(j64 - xo).sum()) / scale
    return row


@pytest.mark.parametrize("ap_oracle", [True, False], ids=["oracle", "no-ap-oracle"])
@pytest.mark.parametrize("algo", ["octree", "bvh"])
def test_trajectory_row_matches_script(script, algo, ap_oracle):
    ours = accuracy.trajectory_row(algo, N, 2, 3, CPU, ap_oracle=ap_oracle)
    ref = _script_row(script, algo, ap_oracle)
    assert list(ours) == list(ref)
    for row in (ours, ref):
        assert 0 < row["ours_fp32fast_vs_f64group"] <= GAP
        assert 0 < row["ours_fp32fast_vs_f64group_canon"] <= GAP
        if ap_oracle:
            assert abs(row["ours_fp32fast_vs_oracle"] - row["ours_f64group_vs_oracle"]) \
                <= row["ours_fp32fast_vs_f64group"] * (1 + 1e-9)
    if ap_oracle:
        k = "ours_f64group_vs_oracle"
        assert abs(ours[k] - ref[k]) <= 1e-6 * ref[k], (ours[k], ref[k])


def test_evolved_study_writes_beside_out(tmp_path, capsys):
    out = tmp_path / "acc.json"
    rows = accuracy.study(512, 2, [2], ["octree"], CPU, evolved=True, out=str(out))
    assert ("# reference legs skipped: the reference binary cannot start from the evolved "
            "state") in capsys.readouterr().err
    assert (tmp_path / "preroll_512_2d_50.npz").exists()
    assert json.loads(out.read_text()) == rows
    (row,) = rows
    assert row["evolved"] is True and row["steps"] == 2
    assert set(row) == {"dim", "algo", "n", "steps", "theta", "evolved",
                        "ours_fp32fast_vs_f64group", "ours_fp32fast_vs_f64group_canon",
                        "ours_fp32fast_vs_oracle", "ours_f64group_vs_oracle"}
    assert all(np.isfinite(v) for k, v in row.items() if k.startswith("ours_"))


def test_fresh_study_says_why_the_reference_legs_are_skipped(tmp_path, capsys):
    probe.main(["accuracy", "256", "1", "--dims", "2", "--algos", "octree", "--no-ap-oracle",
                "--out", str(tmp_path / "a.json"), "--device", "cpu"])
    err = capsys.readouterr().err
    assert "# reference legs skipped: no reference source given" in err
    (row,) = json.loads((tmp_path / "a.json").read_text())
    assert not any(k.startswith("ref") or "ref_" in k for k in row)


def test_growth_matches_script_loop(script, tmp_path):
    from nbody_tpu.models import build_galaxy_model

    out = tmp_path / "g.jsonl"
    out.write_text('{"earlier": 1}\n')
    assert probe.main(["acc-growth", str(N), "2", "--dim", "3", "--out", str(out),
                       "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert lines[0] == {"earlier": 1}
    ours = lines[1:]
    ref = []
    for algo in ("bvh", "octree"):  # probe_acc_growth.py:56-78
        cfg64, s64 = build_galaxy_model(N, 3, np.float64)
        cfg32, s32 = build_galaxy_model(N, 3, np.float32)
        step64 = script._make_step(algo, cfg64.replace(theta=0.5), np.float64, fast=False)
        step32 = script._make_step(algo, cfg32.replace(theta=0.5), np.float32, fast=True)
        for k in range(2):
            s64, _ = step64(s64, k)
            s32, _ = step32(s32, k)
            x64, x32 = np.asarray(s64.x, np.float64), np.asarray(s32.x, np.float64)
            a64, a32 = np.asarray(s64.a, np.float64), np.asarray(s32.a, np.float64)
            ref.append({"algo": algo, "dim": 3, "n": N, "step": k + 1,
                        "pos_l1": float(np.abs(x32 - x64).sum() / np.abs(x64).sum()),
                        "acc_l1": float(np.abs(a32 - a64).sum() / np.abs(a64).sum())})
    assert [list(r) for r in ours] == [list(r) for r in ref]
    for o, r in zip(ours, ref):
        assert (o["algo"], o["dim"], o["n"], o["step"]) == (r["algo"], r["dim"], r["n"], r["step"])
        for key, bound in GROWTH_BOUND.items():
            assert 0 < o[key] <= bound and 0 < r[key] <= bound, (key, o, r)
