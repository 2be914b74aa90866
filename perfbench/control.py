"""The control's readings of the comparison, for a cell's limits.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 [--n N]

The control is the plain reference put in the program's place, computed in
the precision next below the cell's (float64 -> float32, float32 ->
bfloat16): one step from the seed's fresh galaxy, its force computed on the
rows the comparison samples. Prints one JSON line per seed, then the
smallest reading of each number. The program's readings are those of its
own runs: every result line of perfbench.run carries them under `readings`.
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from perfbench import check, galaxy, manifest
from perfbench.reference import direct

LOWER = {"double": "float32", "float": "bfloat16"}


def control_readings(book: manifest.Manifest, workload: str, seed: int, device, n=None) -> dict:
    import torch

    cell = book.cell(workload)
    cfg, mix = book.config(cell["config"]), book.mix(cell["traffic"])
    n = n or cfg["n"]
    dtype = np.float64 if mix["precision"] == "double" else np.float32
    m, x, v = (torch.as_tensor(a, device=device)
               for a in galaxy.bodies(cfg, seed, n, dtype))
    ao = torch.zeros_like(x)
    eps = float(np.finfo(dtype).eps)
    rows = check.sample_rows(seed, 2, n, mix["force_sample"])
    low = getattr(torch, LOWER[mix["precision"]])
    # the softening's eps is the machine epsilon of the precision computed in
    out = direct.step_rows(m, x, v, ao, torch.as_tensor(rows, device=device), cfg["G"],
                           torch.finfo(low).eps, cfg["dt"], cfg["softening"], low)
    spec = {"dt": cfg["dt"], "G": cfg["G"], "eps": eps, "softening": cfg["softening"]}
    return check.compare_step({"m": m, "x": x, "v": v, "ao": ao}, out, spec, rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--n", type=int, default=None, help="bodies (default: the configuration's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    device = torch.device(args.device)
    book = manifest.Manifest()
    seeds = [int(s) for s in args.seeds.split(",")]
    readings = []
    for seed in seeds:
        readings.append(control_readings(book, args.workload, seed, device, args.n))
        print(json.dumps({"workload": args.workload, "side": "control", "seed": seed,
                          **readings[-1]}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(seeds),
                      "control_min": {k: min(r[k] for r in readings) for k in check.NUMBERS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
