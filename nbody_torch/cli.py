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
--kernel torch (through its plain twin), as nbody_tpu chooses; with
--traversal per-body they run the reference's per-body walk (a CUDA
thread a body) in either precision. The bvh re-sorts every --sort-every
steps and refines its fast path's residual --refine-levels deep.
--profile DIR writes a torch.profiler trace of the run into DIR.

--mesh N > 1 runs the multi-device layouts, one process a rank
(parallel/launch.py: nccl where every rank has a card of its own, else
gloo, the ranks sharing the cards in turn, or on the CPU). The replicated
layout (the default) runs on N ranks: all-pairs and all-pairs-collapsed
take the ring, the octree and the bvh sort and build on every rank and
evaluate their own rows. --mesh-layout partitioned runs the octree and the
bvh on N * --mesh-tile ranks: the distributed sort, the coarse heap and
the halo near field over N body ranks, each body rank's rows evaluated by
--mesh-tile ranks (parallel/tree_partitioned.py). All-pairs ignores the
layout, and the replicated layouts --mesh-tile, as nbody_tpu does. Every
rank runs the same step loop; rank 0 alone writes the text (which the
launching process writes to `out`), the saved files, the state file and
the profile, and the run fails unless every rank ends with the same
(gathered) state, bit for bit.

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
--workload plummer|galaxy|uniform(default)|load <file.bin>\t\tSelects workload
--print-state\t\tPrint the initial and final state of the simulation
--print-info\t\tPrint info every timestep
--save pos|energy|all|none(default) \t\tSelects what data to save every timestep
--csv-detailed\t\tPer-phase timing CSV, saves every step
--csv-total\t\tSingle-row timing CSV (excludes printing/saving)
--kernel auto|cuda|torch\t\tForce backend: CUDA kernel (auto on a GPU) or plain torch
\t\t(octree and bvh with --kernel torch or in double take their list paths)
--device auto|cpu|cuda\t\tTorch device (default auto: the GPU; cpu only when asked for)
--mesh N\t\tShard bodies across N ranks, one process each (default 1)
--mesh-layout L\treplicated (default) | partitioned (octree/bvh: sharded
\t\tbodies + distributed sort, O(n/S) per rank; read only when --mesh > 1)
--mesh-tile T\t\tPartitioned 2-D mesh: T tile-axis ranks per body rank
\t\t(mesh x T ranks total; row-shards the force evaluation)
--chunk N\t\tAccepted for nbody_tpu parity; nbody_torch sizes its row chunks from n
--fix-collapsed-z\t\tFix the reference's frozen-z quirk in all-pairs-collapsed
--sort-every K\t\tRe-sort bodies every K steps in tree engines (default 1)
--traversal group|per-body\t\tTree traversal strategy (default group)
--group-tile N\t\tBodies per tile in group traversal (default 512)
--refine-levels N\t\tBVH residual refinement depth (default auto)
--window-tiles N\t\tNear-field window width in tiles (default 32)
--save-state file.bin\t\tWrite final state in the loadable format
--profile DIR\t\tProfiler trace of the run
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


def mesh_world(args: dict) -> int:
    """The ranks of a --mesh run (EngineOptions.mesh_ranks)."""
    from nbody_torch.sim.engines import EngineOptions

    return EngineOptions(mesh=args["mesh"], mesh_layout=args["mesh_layout"],
                         mesh_tile=args["mesh_tile"]).mesh_ranks(args["algorithm"])


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


def profiled(trace_dir: str, device, fn, *args):
    """fn(*args) under torch.profiler (the host's activities, and the
    card's on a GPU), the analog of nbody_tpu's jax.profiler.trace
    (nbody_tpu/cli.py:290-297): one Chrome trace, trace.json, written into
    trace_dir (made if missing), which chrome://tracing and Perfetto read.
    Returns what fn returns."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        result = fn(*args)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return result


def simulate(args: dict, device, out=None, rank: int = 0):
    """Build the model, run the simulation and save the state, as the
    parsed flags `args` say, on `device`. Rank `rank` of a --mesh run
    writes no file and takes no profile unless it is rank 0. Returns the
    final state."""
    from nbody_torch.models import build_model
    from nbody_torch.sim.engines import EngineOptions
    from nbody_torch.sim.runner import RunOptions, run_simulation

    dtype = precision_dtype(args["precision"])
    cfg, state = build_model(
        args["workload"], args["size"], args["dim"], dtype, args["load_input"],
        device=device,
    )
    cfg = cfg.replace(theta=args["theta"])
    writes = rank == 0

    opts = RunOptions(
        steps=args["steps"],
        warmup_steps=args["warmup_steps"],
        print_state=args["print_state"],
        print_info=args["print_info"],
        save_pos=args["save_pos"] and writes,
        save_energy=args["save_energy"] and writes,
        csv_detailed=args["csv_detailed"],
        csv_total=args["csv_total"],
        engine_opts=EngineOptions(
            kernel=args["kernel"],
            fix_z=args["fix_z"],
            sort_every=args["sort_every"],
            traversal=args["traversal"],
            group_tile=args["group_tile"],
            refine=args["refine"],
            window_tiles=args["window_tiles"],
            mesh=args["mesh"],
            mesh_layout=args["mesh_layout"],
            mesh_tile=args["mesh_tile"],
        ),
        out=out,
    )
    if args["profile"] and writes:
        state = profiled(args["profile"], device, run_simulation, args["algorithm"], cfg, state,
                         opts)
    else:
        state = run_simulation(args["algorithm"], cfg, state, opts)
    if args["save_state"] and writes:
        from nbody_torch.io.saving import save_system

        save_system(args["save_state"], state, cfg)
    return state


def mesh_rank(mesh, args: dict) -> dict:
    """One rank of a --mesh run (parallel.launch.spawn's fn): simulate on
    the rank's device, and report rank 0's text, a digest of the final
    state, the kernels' launch counts and the device's peak memory (both
    from 0 at the run's start), and the group's backend."""
    import hashlib
    import io

    import torch

    from nbody_torch.ops import cuda_allpairs, cuda_group_eval, cuda_tree_walk

    counted = (cuda_group_eval, cuda_allpairs, cuda_tree_walk)
    for module in counted:
        module.reset_launch_counts()
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    out = io.StringIO()
    state = simulate(args, mesh.device, out, mesh.rank)
    digest = hashlib.sha256()
    for arr in state.to_numpy().values():
        digest.update(arr.tobytes())
    return {"rank": mesh.rank, "text": out.getvalue() if mesh.rank == 0 else "",
            "state_digest": digest.hexdigest(),
            "launches": {k: v for module in counted for k, v in module.launch_counts.items()},
            "peak_memory": torch.cuda.max_memory_allocated(mesh.device) if on_card else None,
            "backend": mesh.backend, "device": str(mesh.device),
            "ranks_per_card": mesh.ranks_per_card}


def run_mesh(args: dict, device, out=None) -> list[dict]:
    """--mesh N > 1: the simulation on mesh_world(args) ranks
    (parallel.launch), rank 0's text written to `out`. Raises if the
    ranks' final states differ, and before any rank starts where the
    partitioned bvh refuses its sizes (as nbody_tpu's step maker does).
    Returns the ranks' reports (mesh_rank)."""
    from nbody_torch.parallel import launch, tree_partitioned

    if args["mesh_layout"] == "partitioned" and args["algorithm"] == "bvh":
        tree_partitioned.check_bvh_layout(args["mesh"], tree_partitioned.TILE, args["mesh_tile"])
    reports = launch.spawn(mesh_world(args), device.type, mesh_rank, args)
    (sys.stdout if out is None else out).write(reports[0]["text"])
    differ = [r["rank"] for r in reports if r["state_digest"] != reports[0]["state_digest"]]
    if differ:
        raise RuntimeError(f"--mesh {args['mesh']}: the final states of ranks {differ} differ "
                           "from rank 0's")
    return reports


def main(argv: list[str] | None = None, out=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    args = parse_args(list(argv))
    device = resolve_device(args["device"])
    if args["mesh"] > 1:
        run_mesh(args, device, out)
    else:
        simulate(args, device, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
