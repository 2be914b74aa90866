"""python -m nbody_torch.probe accuracy (nbody_torch/probes/accuracy.py), the
port of scripts/accuracy_study.py, against the script's own functions run
on nbody_tpu on the CPU (its float32 fast paths in Pallas interpret mode,
as its _make_step sets them up). The script's main() and preroll_state
write into the repo's results/, so only its other functions are called.

Held:
* oracle_force (the float64 all-pairs kernel's twin here) against the
  script's, both softenings, 2-D and 3-D: within 1e-12 of each row's
  G * sum |term|;
* _canon_l1 equal to the script's;
* the --force-error rows at n = 4,096, octree and BVH, 2-D and 3-D, against
  the rows rebuilt from the script's force_at_state and oracle_force: the
  same keys; the f64group values within 1e-6 relative (or both under 1e-12,
  a leg exact to rounding); the fp32fast values under F32_BOUND on both
  sides, not to each other (the twins and interpret mode round the
  reciprocal differently: ROADMAP's "Interpret-mode reciprocal");
* the subcommand through probe.main with --device cpu (its JSON list, its
  table, its dumps beside --out), its refusal to run without a GPU
  otherwise, and that none of the new modules imports jax, nbody_tpu,
  scripts or tests.
"""

import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from nbody_torch import probe
from nbody_torch.config import SimConfig
from nbody_torch.ops.cuda_allpairs import allpairs_block_abs_torch
from nbody_torch.probes import accuracy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
N_FORCE = 4096
# one bound for a float32 leg's force error at n = 4,096 on both sides:
# interpret mode's p50 is ~2e-6, the twins' ~1e-7
F32_BOUND = {"vs_apf64": 1e-5, "relerr_p50": 1e-5, "relerr_p99": 1e-4, "relerr_max": 1e-3}
F64_REL, F64_FLOOR = 1e-6, 1e-12
FORCE_KEYS = [f"force_{leg}_{k}" for leg in ("fp32fast", "f64group") for k in F32_BOUND]


def _script():
    spec = importlib.util.spec_from_file_location("accuracy_study",
                                                  ROOT / "scripts" / "accuracy_study.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def script():
    return _script()


def _bodies(n, dim, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 10, (n, dim))
    x[:4] = x[4:8] + 1e-9  # close pairs, where the softenings part
    return rng.uniform(0.1, 1, n), x


@pytest.mark.parametrize("softening", ["allpairs", "octree"])
@pytest.mark.parametrize("dim", [2, 3])
def test_oracle_force_matches_script(script, softening, dim):
    m, x = _bodies(1500, dim, 3 + dim)
    cfg = SimConfig(n=1500, dim=dim, dtype=np.float32, G=1e-4)
    got = accuracy.oracle_force(m, x, cfg, softening, CPU)
    ref = script.oracle_force(m, x, cfg, softening)
    xt = torch.tensor(x)
    scale = cfg.G * allpairs_block_abs_torch(xt, torch.tensor(m), xt, cfg.eps,
                                             "sqrt3" if softening == "octree" else "poly").numpy()
    assert got.shape == ref.shape == x.shape
    assert np.all(np.abs(got - ref) <= 1e-12 * scale.sum(axis=1, keepdims=True))


def test_canon_l1_matches_script(script):
    rng = np.random.default_rng(5)
    xa = rng.normal(size=(300, 3))
    xb = (xa + rng.normal(0, 1e-6, xa.shape))[rng.permutation(300)]
    assert accuracy._canon_l1(xa, xb) == script._canon_l1(xa, xb)
    assert accuracy._canon_l1(xa, xa[::-1]) == 0.0


def _script_row(script, algo, dim):
    """The script's --force-error row, rebuilt from its functions."""
    row = {"dim": dim, "algo": algo, "n": N_FORCE, "steps": 0, "theta": script.THETA,
           "evolved": False}
    for dtype, fast, label in ((np.float32, True, "fp32fast"), (np.float64, False, "f64group")):
        av, mv, xv, cfg = script.force_at_state(algo, N_FORCE, dim, dtype, script.THETA, fast)
        ao = script.oracle_force(mv, xv, cfg, "octree" if algo == "octree" else "allpairs")
        row[f"force_{label}_vs_apf64"] = float(np.abs(av - ao).sum()) / float(np.abs(ao).sum())
        rel = np.linalg.norm(av - ao, axis=1) / np.maximum(np.linalg.norm(ao, axis=1), 1e-300)
        for tag, q in (("p50", 50), ("p99", 99)):
            row[f"force_{label}_relerr_{tag}"] = float(np.percentile(rel, q))
        row[f"force_{label}_relerr_max"] = float(rel.max())
    return row


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("algo", ["octree", "bvh"])
def test_force_error_row_matches_script(script, tmp_path, algo, dim):
    ours = accuracy.force_error_row(algo, N_FORCE, dim, accuracy.LEGS, CPU,
                                    dump_dir=str(tmp_path))
    ref = _script_row(script, algo, dim)
    assert list(ours) == list(ref)
    assert all(ours[k] == ref[k] for k in ("dim", "algo", "n", "steps", "theta", "evolved"))
    for key, bound in F32_BOUND.items():
        k = f"force_fp32fast_{key}"
        assert 0 < ours[k] <= bound and 0 < ref[k] <= bound, (k, ours[k], ref[k])
    for key in F32_BOUND:
        k = f"force_f64group_{key}"
        assert (abs(ours[k] - ref[k]) <= F64_REL * ref[k]
                or max(ours[k], ref[k]) <= F64_FLOOR), (k, ours[k], ref[k])
    for label in accuracy.LEGS:
        with np.load(tmp_path / f"forcedump_{algo}_{dim}d_{label}.npz") as z:
            assert z["a_leg"].shape == z["a_oracle"].shape == (N_FORCE, dim)


def test_subcommand_force_error(tmp_path, capsys):
    out = tmp_path / "acc.json"
    assert probe.main(["accuracy", "512", "0", "--force-error", "--dims", "2", "--algos",
                       "octree", "--legs", "fp32fast", "--out", str(out),
                       "--device", "cpu"]) == 0
    rows = json.loads(out.read_text())
    assert len(rows) == 1
    assert set(rows[0]) == {"dim", "algo", "n", "steps", "theta", "evolved",
                            *(k for k in FORCE_KEYS if "fp32fast" in k)}
    printed = capsys.readouterr().out.splitlines()
    assert json.loads(printed[0]) == rows[0]
    assert printed[2].startswith("| dim | algo | evolved | force_fp32fast_relerr_max |")
    assert printed[-1].startswith("| 2 | octree | False | ")
    assert (tmp_path / "forcedump_octree_2d_fp32fast.npz").exists()


def test_subcommands_need_a_gpu_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    for argv in (["accuracy", "64", "1", "--out", str(tmp_path / "a.json")],
                 ["acc-growth", "64", "1", "--out", str(tmp_path / "g.jsonl")],
                 ["nasa", "--synthetic", "10", "--workdir", str(tmp_path / "w")],
                 ["mesh-scaling", "--n", "64"]):
        with pytest.raises(SystemExit) as exc:
            probe.main(argv)
        assert exc.value.code == 1
    assert not any(tmp_path.iterdir())


MODULES = ["nbody_torch/probe.py", "nbody_torch/probes/accuracy.py",
           "nbody_torch/probes/nasa.py", "nbody_torch/probes/mesh_scaling.py",
           "nbody_torch/probes/reference.py"]


@pytest.mark.parametrize("path", MODULES)
def test_module_imports_nothing_of_jax_or_the_scripts(path):
    tree = ast.parse((ROOT / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    bad = sorted(n for n in names
                 if n.split(".")[0] in ("jax", "jaxlib", "nbody_tpu", "scripts", "tests",
                                        "accuracy_study", "conv_csv", "check_state", "plotter",
                                        "ref_oracle", "nasa"))
    assert not bad, bad
