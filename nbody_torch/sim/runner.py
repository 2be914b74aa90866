"""Simulation driver: warmup protocol, timing, CSV, saving, print modes.

The port of nbody_tpu.sim.runner, faithful to the reference's run loops
(all_pairs.h:52-106) and run_simulation wrapper (main.cpp:20-40):

* default mode: `warmup_steps` untimed iterations, then `steps - warmup`
  timed iterations; the reported nsteps is steps - warmup. The reference
  always runs the full warmup loop even when steps < warmup (so `-s 5`
  actually runs 10 steps); we replicate that.
* --csv-detailed: every step is timed per phase and saved; all `steps`
  iterations are timed. It ignores the BVH's --sort-every cadence (every
  step re-sorts), as nbody_tpu's detailed path does.
* --csv-total with any print/save flag aborts (all_pairs.h:58-62).
* CSV schema: algorithm,dim,precision,nsteps,nbodies,total [s][,phases...]
  with seconds formatted {:.2f}.

The step loop is a plain Python loop that queues the kernels. All-pairs
copies nothing to the host in it unless --print-info asks for per-step
output; the octree step reads two counters on the host (its one
synchronisation, see ops/octree_group). Overflow counts stay on the
device and are read once after the loop. The engine builds and loads the
CUDA kernels when the step is made, before the timer starts, and the timer
reads the clock after torch.cuda.synchronize() at both ends.

Under --mesh N every rank runs this loop with the same flags, so that the
engines' collectives meet in step; the CLI (cli.mesh_rank) keeps rank 0's
output and lets no other rank write a file. A step that keeps only its
rank's block of the state (the partitioned layout's PartitionedStep) has
shard and gather methods: the loop shards the state before the first step
and gathers it after the timer stops.
"""

from __future__ import annotations

import dataclasses
import sys
import time as _time

import numpy as np
import torch

from nbody_torch.config import SimConfig
from nbody_torch.io.saving import Saver
from nbody_torch.sim.engines import EngineOptions, get_engine, sync
from nbody_torch.state import SystemState, format_state


@dataclasses.dataclass
class RunOptions:
    """The reference's Arguments (src/arguments.h:23-38) minus model fields."""
    steps: int = 1
    warmup_steps: int = 10
    print_state: bool = False
    print_info: bool = False
    save_pos: bool = False
    save_energy: bool = False
    csv_detailed: bool = False
    csv_total: bool = False
    engine_opts: EngineOptions = dataclasses.field(default_factory=EngineOptions)
    out: object = None  # output stream; defaults to sys.stdout

    def __post_init__(self):
        if self.out is None:
            self.out = sys.stdout


def _precision_bits(dtype) -> int:
    return np.dtype(dtype).itemsize * 8


def _check_overflow(counts: list) -> None:
    """Warn once on interaction-list truncation (nbody_tpu/sim/runner.py:75-87):
    a nonzero count means tiles beyond the exact-fallback budget lost force
    contributions."""
    if not counts:
        return
    total = int(torch.stack(counts).sum())
    if total > 0:
        print(f"WARNING: interaction-list overflow on {total} tile-step(s); "
              "some forces were truncated. Increase --group-tile or the list "
              "caps, or use --traversal per-body.", file=sys.stderr)


def run_algorithm(algo_name: str, cfg: SimConfig, state: SystemState,
                  opts: RunOptions) -> SystemState:
    """The analog of one run_* entry point: owns the Saver, the step loop,
    and the CSV emission."""
    engine = get_engine(algo_name)
    device = state.device
    out = opts.out

    if opts.csv_total:
        # csv-total excludes every other output (all_pairs.h:58-62 abort()s)
        if opts.print_state or opts.print_info or opts.save_pos or opts.save_energy:
            raise RuntimeError(
                "--csv-total cannot be combined with printing or saving"
            )

    print_header = (opts.csv_total or opts.csv_detailed) if engine.header_in_detailed \
        else opts.csv_total
    if print_header:
        cols = "algorithm,dim,precision,nsteps,nbodies,total [s]"
        if opts.csv_detailed:
            cols += ",force [s],accel [s]"
            cols += "".join(f",{p} [s]" for p in engine.csv_phases)
        print(cols, file=out)

    overflow = []  # per-step device counts, summed and read once at the end

    def after_step(s: SystemState, aux: dict) -> None:
        if "overflow" in aux:
            overflow.append(aux["overflow"])
        if opts.print_info:
            msg = engine.info(s, cfg, aux)
            if msg:
                print(msg, file=out, end="")

    reported_steps = opts.steps
    phase_totals: dict[str, float] = {}

    with Saver(opts.save_pos, opts.save_energy, cfg.n, opts.steps, cfg.dim,
               cfg.dtype) as saver:
        saver.save_all(state, cfg)
        if opts.print_info:
            # octree prints "Tree init complete" once before its loop (octree.h:287)
            print(getattr(engine, "pre_info", ""), file=out, end="")
        if opts.csv_detailed:
            detailed = engine.make_detailed(cfg, opts.engine_opts, device)
            sync(device)
            t0 = _time.perf_counter()
            for _ in range(opts.steps):
                state, phases, aux = detailed(state)
                for k, v in phases.items():
                    phase_totals[k] = phase_totals.get(k, 0.0) + v
                after_step(state, aux)
                saver.save_all(state, cfg)
            sync(device)
            dt_total = _time.perf_counter() - t0
        else:
            step = engine.make_step(cfg, opts.engine_opts, device)
            blocks = hasattr(step, "shard")
            if blocks:
                state = step.shard(state)
            # the global step index: warmup 0..warmup-1, then the timed
            # steps from warmup_steps on (nbody_tpu/sim/runner.py:152-168)
            for k in range(opts.warmup_steps):
                state, aux = step(state, k)
                after_step(state, aux)
            sync(device)
            t0 = _time.perf_counter()
            for k in range(opts.warmup_steps, max(opts.warmup_steps, opts.steps)):
                state, aux = step(state, k)
                after_step(state, aux)
            sync(device)
            dt_total = _time.perf_counter() - t0
            reported_steps = opts.steps - opts.warmup_steps
            if blocks:
                state = step.gather(state)
    _check_overflow(overflow)

    if opts.csv_detailed or opts.csv_total:
        row = (
            f"{engine.name},{cfg.dim},{_precision_bits(cfg.dtype)},"
            f"{reported_steps},{cfg.n},{dt_total:.2f}"
        )
        if opts.csv_detailed:
            row += f",{phase_totals.get('force', 0.0):.2f}"
            row += f",{phase_totals.get('accel', 0.0):.2f}"
            for p in engine.csv_phases:
                row += f",{phase_totals.get(p, 0.0):.2f}"
        print(row, file=out)
    return state


def run_simulation(algo_name: str, cfg: SimConfig, state: SystemState,
                   opts: RunOptions) -> SystemState:
    """run_simulation (main.cpp:20-40): optional state dumps and wall time
    around the algorithm run."""
    out = opts.out
    if opts.print_state:
        print("Starting state:", file=out)
        print(format_state(state), file=out)
    quiet = opts.csv_total or opts.csv_detailed
    if not quiet:
        print("Starting simulation", file=out)
    t0 = _time.perf_counter()
    state = run_algorithm(algo_name, cfg, state, opts)
    dt_ms = (_time.perf_counter() - t0) * 1e3
    if opts.print_state:
        print("Final state:", file=out)
        print(format_state(state), file=out)
    if not quiet:
        print(f"Done simulation\nTotal time: {dt_ms:.2f} ms", file=out)
    return state
