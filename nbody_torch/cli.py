"""Command-line driver: python -m nbody_torch.cli (or python -m nbody_torch).

The port of nbody_tpu.cli: the same flag surface, flag loop and defaults
as the reference CLI (src/arguments.h:23-156, src/main.cpp:67-74): -n, -s,
--theta, --precision, --algorithm, --workload, --print-state, --print-info,
--save, --csv-detailed, --csv-total, --help, plus -d/--dim (default 2).

Extensions: --kernel (auto|cuda|torch force backend), --device
(auto|cpu|cuda, in place of nbody_tpu's --platform), --fix-collapsed-z,
--save-state/--load-state. --chunk is parsed as nbody_tpu parses it and
changes nothing: the plain torch path sizes its row chunks from n.

The octree and the bvh run their group traversals, with --theta,
--group-tile and --window-tiles: the fast paths in float32, the list
paths in double precision (through the CUDA list kernel) and under
--kernel torch (through its plain twin), as nbody_tpu chooses. Not yet
ported, and refused with exit code 1 rather than ignored: the octree and
the bvh with --traversal per-body, the bvh with --sort-every > 1 or
--refine-levels > 0, --mesh > 1, --mesh-layout partitioned, --mesh-tile
> 1 and --profile.

The port runs on the GPU unless --device cpu asks for the CPU: without a
CUDA device, --device auto (the default) and --device cuda exit 1.
"""

from __future__ import annotations

import sys

from nbody_torch.config import precision_dtype
from nbody_torch.sim.engines import KERNELS

_HELP = """Help:
-n size\t\tNumber of particles to simulate
-s steps\t\tNumber of steps to run simulation for
-d|--dim 2|3\t\tSpatial dimension (default 2)
--theta t\t\tTheta threshold parameter to use in Octree
--precision double|float(default)\t\tSelects floating-point precision
--algorithm all-pairs|all-pairs-collapsed|bvh|octree(default)\t\tSelects simulation algorithm
\t\t(octree and bvh with --traversal per-body are not yet ported to nbody_torch)
--workload plummer|galaxy|uniform(default)|load <file.bin>\t\tSelects workload
--print-state\t\tPrint the initial and final state of the simulation
--print-info\t\tPrint info every timestep
--save pos|energy|all|none(default) \t\tSelects what data to save every timestep
--csv-detailed\t\tPer-phase timing CSV, saves every step
--csv-total\t\tSingle-row timing CSV (excludes printing/saving)
--kernel auto|cuda|torch\t\tForce backend: CUDA kernel (auto on a GPU) or plain torch
\t\t(octree and bvh with --kernel torch or in double take their list paths)
--device auto|cpu|cuda\t\tTorch device (default auto: the GPU; cpu only when asked for)
--mesh N\t\tShard bodies across N devices (only 1 is ported)
--mesh-layout L\treplicated (default) | partitioned (not yet ported)
--mesh-tile T\t\tPartitioned 2-D mesh tile shards (only 1 is ported)
--chunk N\t\tAccepted for nbody_tpu parity; nbody_torch sizes its row chunks from n
--fix-collapsed-z\t\tFix the reference's frozen-z quirk in all-pairs-collapsed
--sort-every K\t\tRe-sort bodies every K steps in tree engines (default 1; bvh: only 1 is ported)
--traversal group|per-body\t\tTree traversal strategy (default group)
--group-tile N\t\tBodies per tile in group traversal (default 512)
--refine-levels N\t\tBVH residual refinement depth (default auto; only 0 is ported)
--window-tiles N\t\tNear-field window width in tiles (default 32)
--save-state file.bin\t\tWrite final state in the loadable format
--profile DIR\t\tProfiler trace of the run (not yet ported)
--help\t\tDisplay this help message and quit
"""


def parse_args(argv: list[str]) -> dict:
    """Hand-rolled flag loop mirroring parse_args (arguments.h:40-156) and
    nbody_tpu.cli.parse_args; raises SystemExit on unknown flags exactly
    like the reference."""
    args = {
        "size": 1000,
        "steps": 1,
        "warmup_steps": 10,
        "dim": 2,
        "precision": "float",
        "workload": "uniform",
        "algorithm": "octree",
        "theta": 0.5,
        "print_state": False,
        "print_info": False,
        "save_pos": False,
        "save_energy": False,
        "csv_detailed": False,
        "csv_total": False,
        "load_input": None,
        # extensions beyond the reference CLI
        "device": "auto",
        "kernel": "auto",
        "mesh": 1,
        "mesh_layout": "replicated",
        "mesh_tile": 1,
        "chunk": 2048,
        "fix_z": False,
        "sort_every": 1,
        "traversal": "group",
        "group_tile": 512,
        "refine": -1,
        "window_tiles": 32,
        "save_state": None,
        "profile": None,
    }
    i = 0
    while i < len(argv):
        flag = argv[i]
        if flag == "-n":
            i += 1
            args["size"] = int(argv[i])
        elif flag == "-s":
            i += 1
            args["steps"] = int(argv[i])
        elif flag in ("-d", "--dim"):
            i += 1
            args["dim"] = int(argv[i])
        elif flag == "--theta":
            i += 1
            args["theta"] = float(argv[i])
        elif flag == "--csv-detailed":
            args["csv_detailed"] = True
        elif flag == "--csv-total":
            args["csv_total"] = True
        elif flag == "--precision":
            i += 1
            if argv[i] not in ("float", "double"):
                print(f'Unknown precision: "{argv[i]}".', file=sys.stderr)
                print("Options are: double, float (default).", file=sys.stderr)
                raise SystemExit(1)
            args["precision"] = argv[i]
        elif flag == "--algorithm":
            i += 1
            if argv[i] not in ("all-pairs", "all-pairs-collapsed", "octree", "bvh"):
                print(f'Unknown algorithm: "{argv[i]}".', file=sys.stderr)
                print(
                    "Options are: all-pairs, all-pairs-collapsed, bvh, octree (default).",
                    file=sys.stderr,
                )
                raise SystemExit(1)
            args["algorithm"] = argv[i]
        elif flag == "--workload":
            i += 1
            if argv[i] == "load":
                i += 1
                args["load_input"] = argv[i]
                args["workload"] = "load"
            elif argv[i] in ("plummer", "galaxy", "uniform"):
                args["workload"] = argv[i]
            else:
                print(f'Unknown workload: "{argv[i]}".', file=sys.stderr)
                print("Options are: plummer, galaxy, uniform (default).", file=sys.stderr)
                raise SystemExit(1)
        elif flag == "--print-state":
            args["print_state"] = True
        elif flag == "--print-info":
            args["print_info"] = True
        elif flag == "--save":
            i += 1
            if argv[i] == "pos":
                args["save_pos"] = True
            elif argv[i] == "energy":
                args["save_energy"] = True
            elif argv[i] == "all":
                args["save_pos"] = True
                args["save_energy"] = True
            elif argv[i] == "none":
                args["save_pos"] = False
                args["save_energy"] = False
            else:
                print(f'Unknown save options: "{argv[i]}".', file=sys.stderr)
                print("Options are: pos, energy, all, none (default).", file=sys.stderr)
                raise SystemExit(1)
        elif flag == "--kernel":
            i += 1
            if argv[i] not in KERNELS:
                print(f'Unknown kernel: "{argv[i]}".', file=sys.stderr)
                print("Options are: auto (default), cuda, torch.", file=sys.stderr)
                raise SystemExit(1)
            args["kernel"] = argv[i]
        elif flag == "--device":
            i += 1
            if argv[i] not in ("auto", "cpu", "cuda"):
                print(f'Unknown device: "{argv[i]}".', file=sys.stderr)
                print("Options are: auto (default), cpu, cuda.", file=sys.stderr)
                raise SystemExit(1)
            args["device"] = argv[i]
        elif flag == "--mesh":
            i += 1
            args["mesh"] = int(argv[i])
        elif flag == "--mesh-layout":
            i += 1
            if argv[i] not in ("replicated", "partitioned"):
                print(f'Unknown mesh layout: "{argv[i]}".', file=sys.stderr)
                print("Options are: replicated (default), partitioned.",
                      file=sys.stderr)
                raise SystemExit(1)
            args["mesh_layout"] = argv[i]
        elif flag == "--mesh-tile":
            i += 1
            args["mesh_tile"] = int(argv[i])
        elif flag == "--chunk":
            i += 1
            args["chunk"] = int(argv[i])
        elif flag == "--fix-collapsed-z":
            args["fix_z"] = True
        elif flag == "--sort-every":
            i += 1
            args["sort_every"] = int(argv[i])
        elif flag == "--traversal":
            i += 1
            if argv[i] not in ("group", "per-body"):
                print(f'Unknown traversal: "{argv[i]}".', file=sys.stderr)
                print("Options are: group (default), per-body.", file=sys.stderr)
                raise SystemExit(1)
            args["traversal"] = argv[i]
        elif flag == "--group-tile":
            i += 1
            args["group_tile"] = int(argv[i])
        elif flag == "--refine-levels":
            i += 1
            args["refine"] = int(argv[i])
        elif flag == "--window-tiles":
            i += 1
            args["window_tiles"] = int(argv[i])
        elif flag == "--save-state":
            i += 1
            args["save_state"] = argv[i]
        elif flag == "--profile":
            i += 1
            args["profile"] = argv[i]
        elif flag in ("--help", "-h"):
            print(_HELP, end="")
            raise SystemExit(0)
        else:
            print(f"Unknown argument: '{flag}'")
            raise SystemExit(1)
        i += 1

    if args["csv_detailed"] and args["csv_total"]:
        print(
            "Cannot capture a CSV detailed and coarse trace in the same run. "
            "Specify one or the other.",
            file=sys.stderr,
        )
        raise SystemExit(1)
    return args


def _unported(args: dict) -> str | None:
    """What the parsed flags ask for that the port cannot run yet, or None."""
    algo = args["algorithm"]
    if algo in ("octree", "bvh") and args["traversal"] != "group":
        return f'--algorithm {algo} --traversal {args["traversal"]}'
    if algo == "bvh":
        # K <= 1 and R <= 0 are the default branch (re-sort every step, no refinement)
        if args["sort_every"] > 1:
            return f'--algorithm bvh --sort-every {args["sort_every"]}'
        if args["refine"] > 0:
            return f'--algorithm bvh --refine-levels {args["refine"]}'
    if args["mesh"] != 1:
        return "--mesh > 1"
    if args["mesh_layout"] != "replicated":
        return f'--mesh-layout {args["mesh_layout"]}'
    if args["mesh_tile"] != 1:
        return "--mesh-tile > 1"
    if args["profile"]:
        return "--profile"
    return None


def resolve_device(name: str):
    """--device: auto and cuda take the GPU; without one they exit 1,
    never a silent CPU run. Only --device cpu runs on the CPU."""
    import torch

    if name == "cpu":
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    print(f"--device {name}: no CUDA device is available; pass --device cpu to run on the CPU.",
          file=sys.stderr)
    raise SystemExit(1)


def main(argv: list[str] | None = None, out=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    args = parse_args(list(argv))
    missing = _unported(args)
    if missing:
        print(f"{missing} is not yet ported to nbody_torch.", file=sys.stderr)
        raise SystemExit(1)
    device = resolve_device(args["device"])

    from nbody_torch.models import build_model
    from nbody_torch.sim.engines import EngineOptions
    from nbody_torch.sim.runner import RunOptions, run_simulation

    dtype = precision_dtype(args["precision"])
    cfg, state = build_model(
        args["workload"], args["size"], args["dim"], dtype, args["load_input"],
        device=device,
    )
    cfg = cfg.replace(theta=args["theta"])

    opts = RunOptions(
        steps=args["steps"],
        warmup_steps=args["warmup_steps"],
        print_state=args["print_state"],
        print_info=args["print_info"],
        save_pos=args["save_pos"],
        save_energy=args["save_energy"],
        csv_detailed=args["csv_detailed"],
        csv_total=args["csv_total"],
        engine_opts=EngineOptions(
            kernel=args["kernel"],
            fix_z=args["fix_z"],
            traversal=args["traversal"],
            group_tile=args["group_tile"],
            window_tiles=args["window_tiles"],
        ),
        out=out,
    )
    state = run_simulation(args["algorithm"], cfg, state, opts)
    if args["save_state"]:
        from nbody_torch.io.saving import save_system

        save_system(args["save_state"], state, cfg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
