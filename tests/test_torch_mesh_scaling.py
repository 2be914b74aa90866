"""python -m nbody_torch.probe mesh-scaling (nbody_torch/probes/mesh_scaling.py),
the port of scripts/probe_mesh_scaling.py, on the CPU over gloo: shard
counts 1, 2 and 4 (one spawn of S ranks each) at n = 1,024, whose weak
configuration at S = 1 is a 128-body galaxy. Each row carries the
script's keys in its order (partitioned_2d_s only from S = 4), positive
times, the backend and the ranks a card; the table file has the script's
header and one line a shard count; the JSON lines are the rows."""

import json

import pytest
import torch

from nbody_torch import probe
from nbody_torch.probes import mesh_scaling

torch.set_num_threads(1)

N = 1024
KEYS = ["S", "n", "ring_allpairs_s", "sharded_bvh_s", "sharded_octree_s", "partitioned_octree_s",
        "partitioned_2d_s", "partitioned_weak_n", "partitioned_weak_s"]
HEADER = ("| S | ring all-pairs | sharded bvh | sharded octree | partitioned octree "
          "| partitioned 2-D (S/2 x 2) | partitioned weak (n=n*S/8) |")


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling") / "table.md"
    rows = mesh_scaling.run(N, 2, str(out), torch.device("cpu"), shards=(1, 2, 4))
    return rows, out.read_text()


def test_rows_carry_the_script_keys(table):
    rows, _ = table
    assert [r["S"] for r in rows] == [1, 2, 4]
    for r in rows:
        keys = [k for k in KEYS if r["S"] >= 4 or k != "partitioned_2d_s"]
        assert list(r)[:len(keys)] == keys
        assert set(r) - set(keys) == {"backend", "ranks_per_card", "device", "launches"}
        assert r["n"] == N and r["partitioned_weak_n"] == N * r["S"] // 8
        assert all(r[k] > 0 for k in keys if k.endswith("_s"))
        assert (r["backend"], r["ranks_per_card"], r["device"]) == ("gloo", 0, "cpu")
        layouts = [k.removesuffix("_s") for k in keys if k.endswith("_s")]
        assert r["launches"] == {k: {} for k in layouts}  # the twins ran, no kernel


def test_table_has_the_script_header(table):
    rows, text = table
    lines = text.splitlines()
    assert lines[0] == HEADER and lines[1] == "|---|---|---|---|---|---|---|"
    assert len(lines) == 2 + len(rows)
    for r, line in zip(rows, lines[2:]):
        cells = [c.strip() for c in line.strip("|").split("|")]
        assert cells[0] == str(r["S"]) and len(cells) == 7
        assert cells[1] == f"{r['ring_allpairs_s']:.3f} s"
        assert cells[5] == (f"{r['partitioned_2d_s']:.3f} s" if r["S"] >= 4 else "-")
        assert cells[6] == f"{r['partitioned_weak_s']:.3f} s (n={r['partitioned_weak_n']})"


def test_subcommand_prints_json_rows(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(mesh_scaling, "SHARDS", (1,))
    assert probe.main(["mesh-scaling", "--n", "512", "--steps", "1", "--out",
                       str(tmp_path / "t.md"), "--device", "cpu"]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    row = json.loads(line)
    assert row["S"] == 1 and row["n"] == 512 and "partitioned_2d_s" not in row
    assert (tmp_path / "t.md").read_text().startswith(HEADER)
