"""The comparison that decides `correct`, driven through whole CPU runs of each
cell at a size a test run holds (the port's plain twins in place of its
kernels): a sound run passes; a run whose timed path is broken underneath
fails, once for each fault a one-chip step can have; and the control, the
reference computed in the next lower precision in the program's place,
fails too."""

import dataclasses

import pytest
import torch

from perfbench import check, control, manifest, run



class FirstStepBook(manifest.Manifest):
    """The benchmark's manifest with the window's first step as the checked
    one, which a short CPU window always reaches, whatever the load."""

    def mix(self, name):
        return {**super().mix(name), "check_step_max": 1}


BOOK = FirstStepBook()
CELLS = [w["name"] for w in BOOK.bench["workloads"]]
SEED = 2**33 + 17
CPU = torch.device("cpu")


def _n(cell):
    """Bodies of a cell's test runs: at 512 the float64 list paths send every
    tile to their exact fallback, as they send nearly every tile at the
    cell's size; 2,048 for the float32 fast paths."""
    return 512 if BOOK.mix(BOOK.cell(cell)["traffic"])["precision"] == "double" else 2048


def _run(cell, seed=SEED):
    return run.run_cell(cell, seed, 0.5, False, device=CPU, book=BOOK, n=_n(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, lines = _run(cell)
    assert result["correct"] and result["failed"] == 0, lines
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(BOOK.limits(cell))


class ShortEpisodeBook(FirstStepBook):
    """Published runs of one step: the window restarts the chain before each
    step."""

    def config(self, name):
        return {**super().config(name), "steps_published": 1}


@pytest.mark.parametrize("cell", ["octree-galaxy3d-1M.f32", "bvh-galaxy3d-1M.f64"])
def test_episodes_restart_from_the_galaxy(cell, monkeypatch):
    """The window restarts the chain from the galaxy every steps_published
    steps and stays correct across the restarts."""
    from perfbench import run as run_module

    starts = []
    restart = run_module._restart
    monkeypatch.setattr(run_module, "_restart", lambda snap: starts.append(1) or restart(snap))
    result, lines = run_module.run_cell(cell, SEED, 0.5, False, device=CPU,
                                        book=ShortEpisodeBook(), n=_n(cell))
    assert result["correct"], lines
    assert len(starts) == result["attempted"] >= 1


def _unchanged(monkeypatch):
    """The step returns its state unchanged: the leapfrog does nothing."""
    from nbody_torch.sim import tree_engines

    monkeypatch.setattr(tree_engines, "leapfrog_step", lambda state, dt: state)


def _half(monkeypatch):
    """Half of the bodies left out: the force of the kept half is taken over
    the kept half alone, its masses doubled (the mean over the rest), and
    the left-out half gets none."""
    from nbody_torch.sim import tree_engines
    from nbody_torch.state import SystemState

    def wrap(force):
        def half_force(state, *args, **kw):
            keep = torch.arange(0, state.n, 2)
            rest = torch.arange(1, state.n, 2)
            sub = SystemState(m=state.m[keep] * 2, x=state.x[keep], v=state.v[keep],
                              a=state.a[keep], ao=state.ao[keep])
            out, aux = force(sub, *args, **kw)
            out = dataclasses.replace(out, m=out.m / 2)
            left = SystemState(m=state.m[rest], x=state.x[rest], v=state.v[rest],
                               a=torch.zeros_like(state.a[rest]), ao=state.ao[rest])
            both = {f: torch.cat([getattr(out, f), getattr(left, f)]) for f in
                    ("m", "x", "v", "a", "ao")}
            return SystemState(**both), aux
        return half_force

    monkeypatch.setattr(tree_engines, "octree_step_force", wrap(tree_engines.octree_step_force))
    monkeypatch.setattr(tree_engines, "bvh_step_force", wrap(tree_engines.bvh_step_force))


def _altered(monkeypatch):
    """One answer altered where it is produced: one body's force, 1% off,
    before the leapfrog uses it."""
    from nbody_torch.sim import tree_engines

    leapfrog = tree_engines.leapfrog_step

    def altered(state, dt):
        a = state.a.clone()
        a[state.n // 3] *= 1.01
        return leapfrog(dataclasses.replace(state, a=a), dt)

    monkeypatch.setattr(tree_engines, "leapfrog_step", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, lines = _run(cell)
    assert not result["correct"], lines
    assert result["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The control at the test size, on three seeds: each fails the cell's
    limits."""
    limits = BOOK.limits(cell)
    for seed in (SEED, SEED + 1, SEED + 2):
        readings = control.control_readings(BOOK, cell, seed, CPU, _n(cell))
        ok, lines = check.verdict(readings, limits)
        assert not ok, lines


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_carries_the_programs_readings(cell):
    """A run's result line holds the program's worst reading of every number
    compared, the lower readings that the limits are set from."""
    result, _ = _run(cell, SEED + 3)
    readings = result["readings"]
    assert set(readings) == set(check.NUMBERS)
    assert readings["unmatched"] == 0 and readings["ao_gap"] == 0
    assert all(result["checks"][k]["value"] == readings[k] for k in result["checks"])
