"""BENCHMARK.json against the benchmark's contract, and cells found by name."""

import json
import re
import shutil

import pytest

from perfbench import manifest

BOOK = manifest.Manifest()
BENCH = BOOK.bench
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["perfbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_texts():
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for g in groups:
        names = [e["name"] for e in BENCH[g]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in BENCH["configs"]:
        assert set(e) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(e["source"]) and TEXT.match(e["why"])
        assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16
    for e in BENCH["workloads"]:
        assert set(e) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and TEXT.match(e["why"])
        assert e["chips"] in (1, 4)
    for e in BENCH["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(e["layer"])
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25


def test_every_cell_reports_what_it_must():
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in cells:
        e2e = {m["name"] for m in BOOK.end_to_end(cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = BOOK.per_layer(cell)
        assert layer and all(m["moves"] in e2e for m in layer)
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_piece_exists_and_is_found_by_name():
    for c in BENCH["configs"]:
        cfg = BOOK.config(c["name"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(cfg)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        BOOK.mix(w["traffic"])
        assert BOOK.limits(w["name"])
        assert BOOK.config(w["config"])["chips"] == w["chips"]
    for m in BENCH["per_layer"]:
        assert callable(BOOK.reader(m["name"]))


def test_new_files_are_found_with_no_edit(tmp_path):
    """A configuration, a mix, a cell's limits and a metric added as files
    and entries are found by name: a CPU run of the new cell reads them."""
    root = tmp_path
    here = root / "perfbench"
    shutil.copytree(manifest.HERE, here, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = BOOK.config("octree-galaxy3d-1M")
    cfg.update(name="octree-galaxy2d-tiny", dim=2, n=1024)
    (here / "configs" / "octree-galaxy2d-tiny.json").write_text(json.dumps(cfg))
    mix = BOOK.mix("f32")
    mix.update(name="f32-short", check_step_max=2)
    (here / "mixes" / "f32-short.json").write_text(json.dumps(mix))
    (here / "limits" / "octree-galaxy2d-tiny.f32-short.json").write_text(
        json.dumps(BOOK.limits("octree-galaxy3d-1M.f32")))
    (here / "metrics" / "steps_seen.py").write_text("def read(rec):\n    return rec['steps']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "octree-galaxy2d-tiny", "source": "test", "reduced": [],
                             "file": "perfbench/configs/octree-galaxy2d-tiny.json", "why": "t"})
    bench["workloads"].append({"name": "octree-galaxy2d-tiny.f32-short", "chips": 1, "why": "t",
                               "config": "octree-galaxy2d-tiny", "traffic": "f32-short"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "step_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    book = manifest.Manifest(root, here)
    assert book.reader("steps_seen")({"steps": 4}) == 4

    import torch

    from perfbench import run

    result, lines = run.run_cell("octree-galaxy2d-tiny.f32-short", 2**35, 0.3, False,
                                 device=torch.device("cpu"), book=book)
    assert result["correct"], lines
    assert set(result["metrics"]) == {"step_s", "setup_s"}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        BOOK.cell("no-such-cell")
