"""The kernel build's cache key (nbody_torch/_build.py), on the CPU: the
library's name carries a hash of every source and every header, so an
edited header is rebuilt instead of loading a stale library."""

from nbody_torch import _build


def test_library_path_hashes_sources_and_headers(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n// a\n')
    (tmp_path / "b.cuh").write_text("// b, first version\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert _build.sources() == [tmp_path / "a.cu"]  # headers are not compiled alone
    (tmp_path / "b.cuh").write_text("// b, second version\n")
    assert _build.library_path() != first
    (tmp_path / "b.cuh").write_text("// b, first version\n")
    assert _build.library_path() == first
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n// a, edited\n')
    assert _build.library_path() != first


def test_repo_sources_and_header():
    names = {p.name for p in _build.CSRC.iterdir()}
    assert {"allpairs.cu", "allpairs_mxu.cu", "entry_probes.cu", "group_eval.cu", "pair.cuh",
            "tiles.cuh"} <= names
    assert [p.name for p in _build.sources()] == ["allpairs.cu", "allpairs_mxu.cu",
                                                  "entry_probes.cu", "group_eval.cu"]
    assert _build.library_path().parent == _build.BUILD_DIR
