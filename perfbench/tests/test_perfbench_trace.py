"""The trace reader: kernels split by the library that defines them, the
union of device intervals, the per-layer readers and the breakdown, on a
recorded Chrome-trace fixture."""

import json
from pathlib import Path

import pytest

from perfbench import manifest, trace

FIXTURE = Path(__file__).parent / "fixtures" / "trace_small.json"


@pytest.fixture
def rec():
    events = json.loads(FIXTURE.read_text())["traceEvents"]
    names = trace.port_kernel_names(manifest.ROOT / "nbody_torch")
    out = trace.record_from_events(events, names, steps=2, wall_s=1e-3)
    out.update(host_syncs=3, bound_s=2e-5)
    return out


def test_port_names_come_from_the_sources():
    names = trace.port_kernel_names(manifest.ROOT / "nbody_torch")
    assert {"allpairs_block_kernel", "entries_kernel", "group_eval_kernel",
            "masked_eval_bits_kernel", "parts_sum_kernel"} <= names
    assert "vectorized_elementwise_kernel" not in names


def test_a_new_kernel_falls_on_the_port_side_by_its_definition(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "new.cu").write_text(
        "template <int D>\n__global__ void __launch_bounds__(256, 2)\nfresh_kernel(float* x) {}\n")
    (tmp_path / "ops.py").write_text(
        "import triton\n\n@triton.jit\n@other\ndef fresh_triton(x_ptr):\n    pass\n")
    assert trace.port_kernel_names(tmp_path) == {"fresh_kernel", "fresh_triton"}


@pytest.mark.parametrize("name, base", [
    ("void allpairs_block_kernel<double, 3, 1, NewtonWeight>(RowArgs<double>)",
     "allpairs_block_kernel"),
    ("void (anonymous namespace)::helper<float>(float*)", "helper"),
    ("void at::native::vectorized_elementwise_kernel<4, F>(int, F)",
     "at::native::vectorized_elementwise_kernel"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH "),
])
def test_kernel_base(name, base):
    assert trace.kernel_base(name) == base


def test_union_of_intervals():
    busy, merged = trace.union_seconds([(100, 150), (120, 160), (300, 400), (160, 170)])
    assert busy == pytest.approx(170e-6)
    assert merged == [(100, 170), (300, 400)]
    assert trace.union_seconds([]) == (0, [])


def test_record_splits_by_library(rec):
    port = [d["name"].split("<")[0] for d in rec["device"] if d["port"]]
    assert port == ["void allpairs_block_kernel", "void entries_kernel"]
    assert rec["busy_s"] == pytest.approx(170e-6)  # [100,160] + [300,400] + [420,430]
    assert rec["gaps"] == [(160.0, 300.0), (400.0, 420.0)]
    assert rec["span_s"] == pytest.approx(330e-6)


@pytest.mark.parametrize("metric, value", [
    ("idle_share", 1 - 170e-6 / 1e-3),
    ("launches_per_step", 1.5),
    ("host_syncs_per_step", 3),
    ("glue_ms_per_step", 0.020),
    ("kernels_ms_per_step", 0.075),
    ("force_roofline", 100 * 2e-5 / 75e-6),
    ("step_mfu", 100 * 2e-5 / 165e-6),  # span [100, 430] over 2 steps
])
def test_readers(rec, metric, value):
    assert manifest.Manifest().reader(metric)(rec) == pytest.approx(value)


@pytest.mark.parametrize("metric", ["idle_share", "launches_per_step", "glue_ms_per_step",
                                    "kernels_ms_per_step", "force_roofline", "step_mfu"])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    empty = trace.record_from_events([], set(), steps=1, wall_s=0.5)
    empty.update(host_syncs=0, bound_s=1e-4)
    assert manifest.Manifest().reader(metric)(empty) is None


def test_breakdown_names_gaps_by_the_host(rec):
    out = trace.breakdown(rec)
    ops = dict(out["device_ops"])
    assert ops["entries_kernel"] == pytest.approx(100e-6)
    assert list(ops)[0] == "entries_kernel"
    assert dict(out["idle_gaps"]) == pytest.approx({"aten::nonzero": 140e-6, "aten::item": 20e-6})
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10
