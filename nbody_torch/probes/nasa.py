"""The NASA asteroid validation pipeline (python -m nbody_torch.probe nasa):
the port of scripts/nasa.py, the counterpart of the reference's
ci/thuering check.

  1. a CSV in the TimThuering schema [id, name, class, mass, x, y, z, vx,
     vy, vz] (AU, AU/day): --csv, or --synthetic N main-belt bodies around
     the Sun, made here from a seed (make_synthetic_csv), with no fetch;
  2. convert: the CSV to the loadable state format (AU and days, G
     rescaled from SI, dt = 1 hour), the port's copy of
     scripts/conv_csv.py's convert;
  3. the octree and all-pairs runs of nbody_torch.cli at the reference's
     NASA configuration: -d 3 --precision double --theta 0.6 --workload
     load <bin> --csv-detailed --save pos, `--steps` steps, each in its
     own directory under --workdir;
  4. check_state: the L1 difference of the two runs' last saved frames
     (the port's copy of scripts/check_state.py), printed as the script's
     two lines; then the reference binary's octree run where --reference
     names the reference's src/main.cpp and g++ builds it
     (probes/reference.py; otherwise a line on stderr says why not), and
     --external, a lastState.csv of another simulator.
"""

from __future__ import annotations

import csv
import os
import random
import struct
import sys

import numpy as np

from nbody_torch.probes import reference

f32 = np.float32
GM_SUN_AU_DAY = 2.9591220828559093e-4  # G * M_sun in AU^3 / day^2


def gravitational_constant_au_day() -> np.float32:
    """G in AU^3 / (unit mass * day^2)."""
    G_SI = 6.67428e-11
    meter_per_au = 1.0 / 1.49597870691e11
    second_per_day = 1.0 / 86400.0
    return f32(G_SI * meter_per_au**3 / second_per_day**2)


def make_synthetic_csv(path: str, n: int, seed: int = 7) -> None:
    """A main-belt-like dataset in the TimThuering schema: the Sun at the
    origin (the first row, as in the real dataset), then n - 1 bodies on
    circular orbits at 2.1-3.3 AU."""
    rng = np.random.default_rng(seed)
    m_sun = GM_SUN_AU_DAY / float(gravitational_constant_au_day())
    rows = [(0, "Sun", "STA", m_sun, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)]
    for i in range(1, n):
        a = rng.uniform(2.1, 3.3)           # semi-major axis [AU]
        ang = rng.uniform(0, 2 * np.pi)
        z = rng.normal(0, 0.05)
        pos = np.array([a * np.cos(ang), a * np.sin(ang), z])
        vnorm = np.sqrt(GM_SUN_AU_DAY / a)  # circular speed [AU/day]
        vel = vnorm * np.array([-np.sin(ang), np.cos(ang), 0.0])
        mass = rng.uniform(1e8, 1e15)
        rows.append((i, f"ast{i}", "MBA", mass, *pos, *vel))
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["id", "name", "class", "mass", "x", "y", "z", "vx", "vy", "vz"])
        w.writerows(rows)


def convert(input_csv: str, output_bin: str, prop: float = 1.0) -> dict:
    """The CSV to the loadable state format: float32 mass, position and
    velocity; exactly coincident positions nudged apart with nextafter; a
    row with a NaN becomes a massless body at a random x (its own
    random.Random(42), so one conversion gives the same bytes in any
    process); with prop < 1 the first prop * N bodies, the header's count
    matching them."""
    rand = random.Random(42)
    skip_count = move_count = 0
    seen = set()
    rows = []
    with open(input_csv, newline="") as fh:
        reader = csv.reader(fh)
        next(reader)  # header
        for row in reader:
            mass = f32(row[3])
            pos = (f32(row[4]), f32(row[5]), f32(row[6]))
            vel = (f32(row[7]), f32(row[8]), f32(row[9]))
            while pos in seen:
                pos = (np.nextafter(pos[0], f32(np.inf)), pos[1], pos[2])
                move_count += 1
            seen.add(pos)
            rec = np.array((mass, *pos, *vel), dtype=np.float32)
            if np.any(np.isnan(rec)):
                rec = np.array((0.0, rand.random(), 0.0, 0.0, 0.0, 0.0, 0.0), np.float32)
                skip_count += 1
            rows.append(rec)
    row_count = int(prop * len(rows))
    rows = rows[:row_count]
    total_mass = float(np.sum([r[0] for r in rows]))
    with open(output_bin, "wb") as out:
        out.write(struct.pack("<ii", row_count, 3))
        out.write(struct.pack("<ff", 1.0 / 24.0, float(gravitational_constant_au_day())))
        np.stack(rows).astype(np.float32).tofile(out)
    print(f"Saved {row_count} bodies")
    print(f"Total mass saved: {total_mass:.60g}")
    print(f"Replaced {skip_count} NaN bodies")
    print(f"Adjusted {move_count} bodies")
    return {"bodies": row_count, "total_mass": total_mass, "nan_replaced": skip_count,
            "moved": move_count}


def read_points(path: str) -> np.ndarray:
    """positions.bin frames as (frames, dim, nbodies), plotter.py's layout:
    the header's nsteps caps the frame count (a run writes one frame more;
    the reference's reader reads nsteps)."""
    nsteps = int(np.fromfile(path, np.uint32, count=4)[1])
    return reference.read_positions(path)[:nsteps].transpose(0, 2, 1)


def final_state(path: str) -> np.ndarray:
    """(nbodies, dim): a positions.bin's last read frame, or a lastState.csv's rows."""
    if path.endswith(".bin"):
        return read_points(path)[-1].swapaxes(0, 1)
    if path.endswith(".csv"):
        with open(path, newline="") as fh:
            reader = csv.reader(fh)
            next(reader)
            return np.array([[float(v) for v in row] for row in reader])
    raise ValueError("Unknown file type")


def check_state(f1: str, f2: str, out=None) -> float:
    """The total and per-body L1 difference of two final states, printed
    as check_state.py prints them; returns the per-body value."""
    s1, s2 = final_state(f1), final_state(f2)
    err = np.abs(s1 - s2).sum()
    print(f"Total absolute difference is {err}", file=out)
    print(f"Absolute difference per body is {err / s1.shape[0]}", file=out)
    return float(err / s1.shape[0])


def run(csv_path: str | None, synthetic: int, external: str | None, steps: int, workdir: str,
        device: str, ref_src: str | None = None) -> dict:
    """The pipeline (the module docstring); nbody_torch.cli runs with
    --device `device`. Returns {algorithm: its positions.bin} and the
    octree vs all-pairs per-body difference under "per_body"."""
    from nbody_torch.cli import main as cli_main

    os.makedirs(workdir, exist_ok=True)
    if not csv_path:
        n = synthetic or 2000
        csv_path = os.path.join(workdir, "sim_sbdb.csv")
        print(f"# generating synthetic dataset ({n} bodies) -> {csv_path}")
        make_synthetic_csv(csv_path, n)
    bin_path = os.path.abspath(os.path.join(workdir, "sim_sbdb_mid.bin"))
    convert(csv_path, bin_path)
    # the reference's NASA configuration (ci/run:155-165)
    argv = ["-s", str(steps), "--precision", "double", "--theta", "0.6", "--workload", "load",
            bin_path, "--csv-detailed", "--save", "pos"]
    outputs = {}
    for algo in ("octree", "all-pairs"):
        outdir = os.path.join(workdir, algo.replace("-", "_"))
        os.makedirs(outdir, exist_ok=True)
        cwd = os.getcwd()
        os.chdir(outdir)
        try:
            print(f"# running {algo} ...")
            cli_main(["-d", "3", "--algorithm", algo, *argv, "--device", device], out=sys.stderr)
        finally:
            os.chdir(cwd)
        outputs[algo] = os.path.join(outdir, "positions.bin")
    ref_positions = None
    why = reference.reference_problem(ref_src)
    if why:
        print(f"# reference oracle unavailable: {why}", file=sys.stderr)
    else:
        refdir = os.path.join(workdir, "reference")
        os.makedirs(refdir, exist_ok=True)
        print("# running the reference binary (sequential oracle) ...")
        reference.run_reference(3, ["--algorithm", "octree", *argv], ref_src,
                                os.path.join(workdir, "build"), cwd=refdir)
        ref_positions = os.path.join(refdir, "positions.bin")
    print("# octree vs all-pairs final positions:")
    per_body = check_state(outputs["octree"], outputs["all-pairs"])
    if ref_positions:
        print("# octree vs REFERENCE BINARY final positions:")
        check_state(outputs["octree"], ref_positions)
    if external:
        print("# octree vs external simulator:")
        check_state(outputs["octree"], external)
    return {**outputs, "per_body": per_body}
