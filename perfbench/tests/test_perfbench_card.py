"""A traced run of a cell on the card, at a size that a test run holds.
Skips where there is no CUDA device; run on the GPU machine with
`python -m pytest perfbench/tests -m cuda`."""

import pytest

from perfbench import manifest, run

BOOK = manifest.Manifest()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["octree-galaxy3d-1M.f32", "bvh-galaxy3d-1M.f32"])
def test_traced_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result, lines = run.run_cell(cell, 2**36 + 5, 1.0, True, device=torch.device("cuda", 0),
                                 book=BOOK, n=65536)
    assert result["correct"], lines
    names = {m["name"] for m in BOOK.per_layer(cell)}
    assert set(result["metrics"]) == names
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert 0 < result["metrics"]["force_roofline"]["value"] <= 100
    assert result["breakdown"]["device_ops"]
