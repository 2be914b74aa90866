"""The CLI end to end: python -m nbody_torch.cli against python -m
nbody_tpu.cli on the same flags, on the CPU (all-pairs), and against
nbody_tpu's octree fast path in interpret mode (octree: the JAX CLI on
the CPU takes the octree's list path, whose box differs).

Exact where the JAX package is exact (headers, CSV columns, file headers
and lengths, printed text in float64, error paths); float values within
a stated tolerance: 1e-12 relative in float64 and 1e-3 relative in
float32, whose --print-state text carries 4 significant digits.
"""

import io
import os
import re
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from nbody_torch import cli as tcli
from nbody_torch.models import build_galaxy_model
from nbody_tpu import cli as jcli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = re.compile(r"[-+]?\d+\.\d+e[-+]\d+")


def _run(main, argv, cwd, monkeypatch):
    monkeypatch.chdir(cwd)
    out = io.StringIO()
    assert main(list(argv), out=out) == 0
    return out.getvalue()


def _both(argv, tmp_path, monkeypatch):
    """(jax_stdout, torch_stdout, jax_dir, torch_dir) of one flag set."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir(exist_ok=True)
    tdir.mkdir(exist_ok=True)
    j = _run(jcli.main, argv, jdir, monkeypatch)
    t = _run(tcli.main, [*argv, "--device", "cpu"], tdir, monkeypatch)
    return j, t, jdir, tdir


def _without_times(text):
    return [ln for ln in text.splitlines() if not ln.startswith("Total time:")]


def _numbers(text):
    return np.array([float(v) for v in NUM.findall(text)])


def _read_state(path):
    raw = path.read_bytes()
    n, dim = struct.unpack("<II", raw[:8])
    return raw[:16], np.frombuffer(raw[16:], np.float32).reshape(n, 1 + 2 * dim)


def test_defaults_and_flag_loop_match_jax():
    j, t = jcli.parse_args([]), tcli.parse_args([])
    shared = set(j) & set(t)
    assert {k: t[k] for k in shared} == {k: j[k] for k in shared}
    assert set(j) - set(t) == {"platform"} and set(t) - set(j) == {"device"}
    assert (t["device"], t["kernel"]) == ("auto", "auto")
    argv = ["-n", "7", "-s", "3", "-d", "3", "--theta", "0.3", "--precision", "double",
            "--algorithm", "all-pairs-collapsed", "--workload", "load", "f.bin",
            "--print-state", "--print-info", "--save", "all", "--csv-detailed",
            "--chunk", "64", "--fix-collapsed-z", "--sort-every", "2", "--traversal",
            "per-body", "--group-tile", "128", "--refine-levels", "1", "--window-tiles", "8",
            "--save-state", "s.bin", "--mesh", "2", "--mesh-layout", "partitioned",
            "--mesh-tile", "2", "--profile", "p"]
    j, t = jcli.parse_args(argv), tcli.parse_args(argv)
    assert {k: t[k] for k in shared} == {k: j[k] for k in shared}


@pytest.mark.parametrize("argv", [
    ["--frobnicate"], ["--precision", "half"], ["--algorithm", "fmm"],
    ["--workload", "sphere"], ["--save", "everything"], ["--csv-detailed", "--csv-total"],
])
def test_flag_errors_exit_like_jax(argv):
    for parse in (jcli.parse_args, tcli.parse_args):
        with pytest.raises(SystemExit) as e:
            parse(argv)
        assert e.value.code == 1


@pytest.mark.parametrize("argv", [["--kernel", "pallas"], ["--device", "tpu"]])
def test_port_flag_values_checked(argv):
    with pytest.raises(SystemExit) as e:
        tcli.parse_args(argv)
    assert e.value.code == 1


@pytest.mark.parametrize("argv", [
    ["--algorithm", "octree", "--traversal", "per-body"],
    ["--algorithm", "octree", "--traversal", "per-body", "-d", "3"],
    ["--algorithm", "octree", "--traversal", "per-body", "--workload", "galaxy", "-n", "201"],
    ["--algorithm", "bvh", "--traversal", "per-body"],
    ["--algorithm", "bvh", "--traversal", "per-body", "-d", "3"],
    ["--algorithm", "bvh", "--traversal", "per-body", "--workload", "galaxy", "-n", "201",
     "-d", "3"],
    ["--algorithm", "bvh", "--traversal", "per-body", "--sort-every", "2"],
    ["--algorithm", "bvh", "--sort-every", "2"],
    ["--algorithm", "bvh", "--sort-every", "3", "-d", "3"],
    ["--algorithm", "bvh", "--refine-levels", "1"],
    ["--algorithm", "all-pairs", "--profile", "trace_dir"],
])
def test_single_device_features_print_like_jax(argv, tmp_path, monkeypatch):
    """The single-device features that once exited 1 here (the per-body
    walks, the BVH's cadence and refinement, --profile) run on both CLIs
    with -n 200 -s 2 (the 10 warmup steps) in double with --print-state
    --print-info, and print the same lines but the times. In double
    nbody_tpu's CLI takes the BVH's list path, which ignores
    --refine-levels, and the port's too. An odd galaxy leaves a massless
    body at the origin."""
    argv = ["-n", "200", "-s", "2", "--precision", "double", "--print-state", "--print-info",
            *argv]
    j, t, _, tdir = _both(argv, tmp_path, monkeypatch)
    assert _without_times(t) == _without_times(j)
    assert "Final state:" in t
    if "--profile" in argv:
        assert (tdir / "trace_dir" / "trace.json").is_file()


@pytest.mark.parametrize("algorithm", ["octree", "all-pairs"])
@pytest.mark.parametrize("mesh", [["--mesh-layout", "partitioned"], ["--mesh-tile", "2"],
                                  ["--mesh", "0"]])
def test_mesh_flags_at_one_device_run_like_jax(mesh, algorithm, tmp_path, monkeypatch):
    """nbody_tpu reads --mesh-layout and --mesh-tile only when --mesh > 1;
    at one device (or --mesh 0) both packages run the single-device step:
    both exit 0 with the same CSV header and as many fields (uniform 2-D
    float32, -n 100 -s 1 --csv-total). nbody_tpu runs on the CPU that
    tests/conftest.py selects: its --platform cpu would also ask JAX for
    mesh * mesh-tile virtual devices, which JAX refuses once its backend
    is up."""
    argv = ["-n", "100", "-s", "1", "--csv-total", "--algorithm", algorithm, *mesh]
    j = _run(jcli.main, argv, tmp_path, monkeypatch).strip().splitlines()
    t = _run(tcli.main, [*argv, "--device", "cpu"], tmp_path, monkeypatch).strip().splitlines()
    assert len(j) == len(t) == 2 and t[0] == j[0]
    assert len(t[1].split(",")) == len(j[1].split(","))
    assert t[1].split(",")[:5] == j[1].split(",")[:5]
    assert j[1].split(",")[:3] + j[1].split(",")[4:5] == [algorithm, "2", "32", "100"]


@pytest.mark.parametrize("argv", [
    ["--precision", "double"], ["--algorithm", "bvh", "--precision", "double"],
    ["--kernel", "torch"], ["--algorithm", "bvh", "--kernel", "torch"],
])
def test_tree_list_paths_run(argv, tmp_path, monkeypatch):
    """The trees' list paths, which float64 and --kernel torch take, run
    (they exited 1 before they were ported): -s 12 leaves a finite state
    that has moved."""
    out = _run(tcli.main, ["-n", "300", "-s", "12", *argv, "--device", "cpu", "--csv-total",
                           "--save-state", "final.bin"], tmp_path, monkeypatch)
    algorithm = "bvh" if "bvh" in argv else "octree"
    precision = "64" if "double" in argv else "32"
    assert out.strip().splitlines()[1].startswith(f"{algorithm},2,{precision},2,300,")
    _, final = _read_state(tmp_path / "final.bin")
    assert np.all(np.isfinite(final)) and np.abs(final[:, 3:5]).sum() > 0


def test_device_cuda_needs_a_gpu(capsys):
    if torch.cuda.is_available():
        assert tcli.resolve_device("cuda").type == "cuda"
        assert tcli.resolve_device("auto").type == "cuda"
    else:
        # --device cuda, --device auto and the default (auto) all exit 1 and
        # name --device cpu: the CPU runs only when asked for
        for device in (["--device", "cuda"], ["--device", "auto"], []):
            with pytest.raises(SystemExit) as e:
                tcli.main(["-n", "8", "--algorithm", "all-pairs", *device], out=io.StringIO())
            assert e.value.code == 1
            err = capsys.readouterr().err
            assert "no CUDA device" in err and "--device cpu" in err
    assert tcli.resolve_device("cpu").type == "cpu"


def test_kernel_cuda_refuses_cpu_device():
    with pytest.raises(ValueError, match="CUDA device"):
        tcli.main(["-n", "8", "--algorithm", "all-pairs", "--kernel", "cuda",
                   "--device", "cpu"], out=io.StringIO())


@pytest.mark.parametrize("precision", ["double", "float"])
def test_print_state_and_warmup_quirk(precision, tmp_path, monkeypatch):
    """-s 5 runs the full 10-step warmup: both CLIs end in the same state,
    which is also the port's -s 10 state."""
    argv = ["-n", "10", "-s", "5", "--algorithm", "all-pairs", "--print-state",
            "--precision", precision]
    j, t, _, _ = _both(argv, tmp_path, monkeypatch)
    jl, tl = _without_times(j), _without_times(t)
    if precision == "double":
        assert tl == jl
    else:
        assert [NUM.sub("#", ln) for ln in tl] == [NUM.sub("#", ln) for ln in jl]
        np.testing.assert_allclose(_numbers(t), _numbers(j), rtol=1e-3, atol=1e-6)
    t10 = _run(tcli.main, [*argv[:3], "10", *argv[4:], "--device", "cpu"], tmp_path,
               monkeypatch)
    assert t10.split("Final state:")[1].split("Done")[0] == t.split("Final state:")[1].split("Done")[0]
    assert "Starting simulation" in t and "Done simulation" in t


@pytest.mark.parametrize("fix_z", [False, True])
def test_collapsed_3d_state_files(fix_z, tmp_path, monkeypatch):
    """all-pairs-collapsed -d 3 keeps the z-freeze (z velocity stays at its
    initial value) unless --fix-collapsed-z; final state files agree."""
    argv = ["-n", "12", "-s", "3", "-d", "3", "--algorithm", "all-pairs-collapsed",
            "--workload", "galaxy", "--precision", "double", "--save-state", "final.bin"]
    argv += ["--fix-collapsed-z"] if fix_z else []
    _, _, jdir, tdir = _both(argv, tmp_path, monkeypatch)
    jh, js = _read_state(jdir / "final.bin")
    th, ts = _read_state(tdir / "final.bin")
    assert th == jh
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-12)
    _, s0 = build_galaxy_model(12, 3, np.float64, torch.device("cpu"))
    vz0 = s0.v[:, 2].numpy().astype(np.float32)
    assert np.array_equal(ts[:, 6], vz0) != fix_z


def test_csv_total_schema(tmp_path, monkeypatch):
    argv = ["-n", "32", "-s", "12", "--algorithm", "all-pairs", "--csv-total"]
    j, t, _, _ = _both(argv, tmp_path, monkeypatch)
    jl, tl = j.strip().splitlines(), t.strip().splitlines()
    assert tl[0] == jl[0] == "algorithm,dim,precision,nsteps,nbodies,total [s]"
    assert tl[1].split(",")[:5] == jl[1].split(",")[:5] == ["all-pairs", "2", "32", "2", "32"]
    assert len(tl) == len(jl) == 2
    float(tl[1].split(",")[5])


@pytest.mark.parametrize("algorithm", ["all-pairs", "all-pairs-collapsed"])
def test_csv_detailed_and_saved_files(algorithm, tmp_path, monkeypatch):
    argv = ["-n", "24", "-s", "3", "-d", "3", "--algorithm", algorithm, "--workload",
            "galaxy", "--csv-detailed", "--save", "all"]
    j, t, jdir, tdir = _both(argv, tmp_path, monkeypatch)
    jl, tl = j.strip().splitlines(), t.strip().splitlines()
    assert len(tl) == len(jl) == 1  # all-pairs prints no header in detailed mode
    assert tl[0].split(",")[:5] == jl[0].split(",")[:5] == [algorithm, "3", "32", "3", "24"]
    assert len(tl[0].split(",")) == len(jl[0].split(",")) == 8
    for name, head in (("positions.bin", 16), ("energy.bin", 8)):
        jb, tb = (jdir / name).read_bytes(), (tdir / name).read_bytes()
        assert tb[:head] == jb[:head] and len(tb) == len(jb), name
        jv = np.frombuffer(jb[head:], np.float32)
        tv = np.frombuffer(tb[head:], np.float32)
        np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-5 * np.abs(jv).max(),
                                   err_msg=name)
    assert struct.unpack("<II", (tdir / "energy.bin").read_bytes()[:8]) == (3, 4)
    assert len((tdir / "positions.bin").read_bytes()) == 16 + 4 * 24 * 3 * 4


def test_save_state_then_load(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "ckpt.bin")
    _run(tcli.main, ["-n", "16", "-s", "2", "--algorithm", "all-pairs", "--device", "cpu",
                     "--save-state", ckpt], tmp_path, monkeypatch)
    argv = ["-s", "1", "--algorithm", "all-pairs", "--precision", "double",
            "--workload", "load", ckpt, "--print-state"]
    j, t, _, _ = _both(argv, tmp_path, monkeypatch)
    assert _without_times(t) == _without_times(j)
    assert "Final state:" in t


def test_kernel_torch_matches_auto(tmp_path, monkeypatch):
    outs = []
    for kernel in ("auto", "torch"):
        _run(tcli.main, ["-n", "40", "-s", "12", "-d", "3", "--algorithm", "all-pairs",
                         "--precision", "double", "--kernel", kernel, "--chunk", "16",
                         "--device", "cpu", "--save-state", f"{kernel}.bin"],
             tmp_path, monkeypatch)
        outs.append(_read_state(tmp_path / f"{kernel}.bin")[1])
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("argv,exc", [
    (["-n", "8", "--algorithm", "all-pairs", "--csv-total", "--print-state"], RuntimeError),
    (["-n", "8", "--algorithm", "all-pairs", "--csv-total", "--save", "pos"], RuntimeError),
    (["--algorithm", "all-pairs", "--workload", "load", "missing.bin"], FileNotFoundError),
    (["-n", "8", "-d", "2", "--algorithm", "all-pairs", "--workload", "plummer"], ValueError),
    (["-n", "8", "-d", "4", "--algorithm", "all-pairs"], ValueError),
])
def test_error_paths_like_jax(argv, exc, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(exc):
        jcli.main(argv, out=io.StringIO())
    with pytest.raises(exc):
        tcli.main([*argv, "--device", "cpu"], out=io.StringIO())


def test_load_dim_mismatch_like_jax(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "c3.bin")
    _run(tcli.main, ["-n", "6", "-s", "0", "-d", "3", "--algorithm", "all-pairs",
                     "--device", "cpu", "--save-state", ckpt], tmp_path, monkeypatch)
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="D=2, but the file provided is D=3"):
            main(["--algorithm", "all-pairs", "--workload", "load", ckpt, *extra],
                 out=io.StringIO())


def test_port_imports_no_jax():
    code = (
        "import io, sys\n"
        "import nbody_torch.cli, nbody_torch.ops.cuda_allpairs, nbody_torch.sim.runner\n"
        "import nbody_torch.probe, nbody_torch.ops.cuda_group_eval, nbody_torch.sim.tree_engines\n"
        "import nbody_torch.parallel.dryrun, nbody_torch.parallel.launch\n"
        "import nbody_torch.parallel.ring, nbody_torch.parallel.tree_sharded\n"
        "for algo in ('all-pairs', 'octree', 'bvh'):\n"
        "    nbody_torch.cli.main(['-n', '64', '-s', '11', '--algorithm', algo,\n"
        "                          '--csv-total', '--device', 'cpu'], out=io.StringIO())\n"
        "nbody_torch.cli.main(['-n', '64', '-s', '11', '--mesh', '2', '--csv-total',\n"
        "                      '--device', 'cpu'], out=io.StringIO())\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'nbody_tpu')))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    CUDA GPU, and in a directory that holds nothing else of the repo."""
    script = os.path.join(ROOT, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(script, "rb").read())
    runs = [[sys.executable, str(lone)]]
    if not torch.cuda.is_available():
        runs.append([sys.executable, script])
    for cmd in runs:
        proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


OCTREE_DETAILED = ("algorithm,dim,precision,nsteps,nbodies,total [s],force [s],accel [s],"
                   "clear [s],bbox [s],insert [s],multipoles [s],force approx [s]")


@pytest.mark.parametrize("dim", ["2", "3"])
@pytest.mark.parametrize("algorithm", [[], ["--algorithm", "octree"]])
def test_octree_runs_by_default(algorithm, dim, tmp_path, monkeypatch):
    """Octree is the default algorithm: -s 12 runs 10 warmup and 2 timed
    steps, and the final state is finite and has moved."""
    argv = ["-n", "700", "-s", "12", "-d", dim, "--workload", "galaxy", *algorithm, "--csv-total",
            "--save-state", "final.bin"]
    t = _run(tcli.main, [*argv, "--device", "cpu"], tmp_path, monkeypatch).strip().splitlines()
    assert t[0] == "algorithm,dim,precision,nsteps,nbodies,total [s]"
    assert t[1].split(",")[:5] == ["octree", dim, "32", "2", "700"]
    _, final = _read_state(tmp_path / "final.bin")
    _, s0 = build_galaxy_model(700, int(dim), np.float32, torch.device("cpu"))
    assert np.all(np.isfinite(final)) and not np.array_equal(final[:, 1:1 + int(dim)],
                                                             s0.x.numpy())


def test_octree_csv_detailed_header_like_jax(tmp_path, monkeypatch):
    argv = ["-n", "64", "-s", "2", "--algorithm", "octree", "--csv-detailed"]
    j, t, _, _ = _both(argv, tmp_path, monkeypatch)
    jl, tl = j.strip().splitlines(), t.strip().splitlines()
    assert tl[0] == jl[0] == OCTREE_DETAILED
    assert tl[1].split(",")[:5] == jl[1].split(",")[:5] == ["octree", "2", "32", "2", "64"]
    assert len(tl[1].split(",")) == len(jl[1].split(",")) == 13


@pytest.mark.parametrize("dim", [2, 3])
def test_octree_print_info_vs_jax_fast_path(dim, tmp_path, monkeypatch):
    """--print-info: "Tree init complete" once, then per step the tree
    size and total mass of nbody_tpu's octree_step_force (fast path, in
    interpret mode) plus leapfrog_step from the same galaxy: sizes equal,
    masses within one float32 ulp (the port sums the masses in float64)."""
    import jax.numpy as jnp

    from nbody_tpu.models import build_model as jbuild
    from nbody_tpu.ops.integrator import leapfrog_step as jleapfrog
    from nbody_tpu.ops.octree import max_depth, octree_step_force

    n, steps = 2048, 3  # JAX needs sub_width | S: n = 1500 gives S = 1536
    argv = ["-n", str(n), "-s", str(steps), "-d", str(dim), "--workload", "galaxy",
            "--print-info", "--csv-detailed", "--device", "cpu"]
    lines = _run(tcli.main, argv, tmp_path, monkeypatch).strip().splitlines()
    assert lines[0] == OCTREE_DETAILED and lines[1] == "Tree init complete"
    info = lines[2:-1]
    assert len(info) == 2 * steps and lines[-1].startswith(f"octree,{dim},32,{steps},{n},")
    cfg, s = jbuild("galaxy", n, dim, np.float32)
    depth = max_depth(n, dim)
    for k in range(steps):
        s, _, aux = octree_step_force(s, cfg.theta, cfg.G, cfg.eps, depth,
                                      use_pallas="interpret")
        s = jleapfrog(s, cfg.dt)
        assert info[2 * k] == f"Tree size: {int(aux['tree_size'])}"
        mass = np.float32(jnp.asarray(aux["root_mass"]))
        assert info[2 * k + 1].startswith("Total mass: ")
        assert abs(float(info[2 * k + 1].split(":")[1]) - mass) <= np.spacing(mass)


BVH_DETAILED = ("algorithm,dim,precision,nsteps,nbodies,total [s],force [s],accel [s],"
                "bbox [s],sort [s],multipoles [s],force approx [s]")


def test_bvh_print_state_like_jax(tmp_path, monkeypatch):
    """-n 10 -s 5 --algorithm bvh --theta 0 --print-state: the JAX CLI on
    the CPU takes the bvh's list path, the port its fast path through the
    twins, and at theta = 0 both sum every pair exactly. The printed state
    is the Hilbert-sorted one: the same body order, values within 1e-4
    relative."""
    argv = ["-n", "10", "-s", "5", "--algorithm", "bvh", "--theta", "0", "--print-state"]
    j, t, _, _ = _both(argv, tmp_path, monkeypatch)
    jl, tl = _without_times(j), _without_times(t)
    assert [NUM.sub("#", ln) for ln in tl] == [NUM.sub("#", ln) for ln in jl]
    np.testing.assert_allclose(_numbers(t), _numbers(j), rtol=1e-4, atol=1e-6)
    assert "Final state:" in t


@pytest.mark.parametrize("dim", ["2", "3"])
def test_bvh_csv_detailed_header_and_info_like_jax(dim, tmp_path, monkeypatch):
    """--csv-detailed prints the bvh's header (bvh.h:342) and --print-info
    the root's total mass each step, as nbody_tpu does."""
    argv = ["-n", "64", "-s", "3", "-d", dim, "--algorithm", "bvh", "--csv-detailed",
            "--print-info"]
    j, t, _, _ = _both(argv, tmp_path, monkeypatch)
    jl, tl = j.strip().splitlines(), t.strip().splitlines()
    assert tl[0] == jl[0] == BVH_DETAILED
    assert tl[1:-1] == jl[1:-1] and len(tl) == 5 and tl[1].startswith("Total mass: ")
    assert tl[-1].split(",")[:5] == jl[-1].split(",")[:5] == ["bvh", dim, "32", "3", "64"]
    assert len(tl[-1].split(",")) == len(jl[-1].split(",")) == 12


@pytest.mark.parametrize("flags", [["--sort-every", "1"], ["--sort-every", "0"],
                                   ["--refine-levels", "0"], ["--refine-levels", "-1"]])
def test_bvh_default_branch_flags_run(flags, tmp_path, monkeypatch):
    """--sort-every K <= 1 and --refine-levels R <= 0 are nbody_tpu's
    default branch (re-sort every step, no refinement): they run."""
    out = _run(tcli.main, ["-n", "64", "-s", "12", "--algorithm", "bvh", "--csv-total", *flags,
                           "--device", "cpu"], tmp_path, monkeypatch)
    assert out.strip().splitlines()[1].startswith("bvh,2,32,2,64,")
