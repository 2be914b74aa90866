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
            "tile_decide.cu", "tiles.cuh", "tree_walk.cu"} <= names
    assert [p.name for p in _build.sources()] == ["allpairs.cu", "allpairs_mxu.cu",
                                                  "entry_probes.cu", "group_eval.cu",
                                                  "tile_decide.cu", "tree_walk.cu"]
    assert _build.library_path().parent == _build.BUILD_DIR


def _c_signatures() -> dict:
    """name -> its parameters' ctypes kinds ("i" int, "d" double, "p" any
    pointer), read from the extern "C" definitions of csrc/*.cu."""
    import re

    kinds = {"int": "i", "double": "d"}
    out = {}
    for src in _build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (nbody_\w+)\(([^)]*)\)', text):
            params = [" ".join(a.split()) for a in m.group(2).split(",") if a.strip()]
            out[m.group(1)] = [("p" if "*" in a else kinds[a.rsplit(" ", 1)[0]]) for a in params]
    return out


def test_ctypes_signatures_match_the_sources():
    """Every C function the library declares takes, in order, the ints,
    doubles and pointers its definition in csrc/ names: ctypes cannot check
    this, and a wrong count shifts every later argument."""
    import ctypes

    kind = {ctypes.c_int: "i", ctypes.c_double: "d", ctypes.c_void_p: "p"}
    defined = _c_signatures()
    for name, args in _build.SIGNATURES:
        assert name in defined, name
        assert [kind[a] for a in args] == defined[name], name
    assert {"nbody_group_eval", "nbody_parts_sum", "nbody_window_eval_nodemask",
            "nbody_window_eval_interval", "nbody_bvh_walk", "nbody_octree_walk"} <= defined.keys()


SASS = """
        code for sm_90a
                Function : _Zkernel
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_1:
        /*0020*/                   LDS.128 R4, [R2] ;
.L_x_2:
        /*0030*/                   FADD R5, R4, -R8 ;
        /*0040*/                   MUFU.RSQ R6, R5 ;
        /*0050*/                   FFMA R7, R5, R6, R3 ;
        /*0060*/                   MUFU.RCP R9, R7 ;
        /*0070*/                   DFMA R10, R4, R4, R10 ;
        /*0080*/              @!P0 BRA `(.L_x_2) ;
        /*0090*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00a0*/               @P1 BRA 0x20 ;
        /*00b0*/                   EXIT ;
                Function : _Zplain
        /*0000*/                   EXIT ;
"""
PTXAS = """ptxas info    : Compiling entry function '_Zkernel' for 'sm_90a'
ptxas info    : Function properties for _Zkernel
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 4096 bytes smem, 400 bytes cmem[0]
"""


def test_probe_sass_counts_the_innermost_mufu_loop():
    """probe sass: the hot loop is the innermost backward branch's range
    with MUFU (labels or addresses as targets), counted by class; two MUFU
    a pair; registers and spills from -Xptxas -v."""
    from nbody_torch.probe import ptxas_usage, sass_loops

    loops = sass_loops(SASS)
    assert loops["_Zplain"] == {}
    assert loops["_Zkernel"] == {"loop_instructions": 6, "mufu": 2, "fp32": 2, "fp64": 1,
                                 "lds": 0, "instructions_per_pair": 6.0}
    assert ptxas_usage(PTXAS) == {"_Zkernel": {"spill_stores": 8, "spill_loads": 4,
                                               "registers": 40}}


FAR_SASS = """
        code for sm_90a
                Function : _Zfast
.L_x_1:
        /*0000*/                   LDS.128 R4, [R2] ;
        /*0010*/                   MUFU.RSQ R6, R5 ;
        /*0020*/                   FMUL R7, R6, R6 ;
        /*0030*/                   MUFU.RSQ R8, R9 ;
        /*0040*/                   FMUL R10, R8, R8 ;
        /*0050*/                   FFMA R11, R10, R8, R11 ;
        /*0060*/               @P0 BRA `(.L_x_1) ;
.L_x_2:
        /*0070*/                   MUFU.RSQ R6, R5 ;
        /*0080*/                   MUFU.RCP R7, R6 ;
        /*0090*/                   MUFU.RSQ R8, R9 ;
        /*00a0*/                   MUFU.RCP R9, R8 ;
        /*00b0*/                   FFMA R11, R9, R8, R11 ;
        /*00c0*/               @P1 BRA `(.L_x_2) ;
        /*00d0*/                   EXIT ;
"""


def test_probe_sass_counts_the_far_loop_at_one_mufu_a_pair():
    """probe sass: beside the hot loop (the most MUFU, two a pair), a
    kernel's far loop, whose MUFU are all rsqrt, at one MUFU a pair."""
    from nbody_torch.probe import sass_loops

    row = sass_loops(FAR_SASS)["_Zfast"]
    assert (row["loop_instructions"], row["mufu"], row["instructions_per_pair"]) == (6, 4, 3.0)
    assert {k: row[k] for k in row if k.startswith("far")} == {
        "far_loop_instructions": 7, "far_mufu": 2, "far_fp32": 3,
        "far_instructions_per_pair": 3.5}


SUM_SASS = """
        code for sm_90a
                Function : _Zsum
        /*0000*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0010*/               @P0 LDG.E.128.CONSTANT R8, desc[UR4][R6.64] ;
        /*0020*/                   LDG.E R12, desc[UR4][R10.64] ;
        /*0030*/                   FADD R4, R4, R8 ;
        /*0040*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0050*/                   EXIT ;
                Function : _Zplain
        /*0000*/                   EXIT ;
"""


def test_probe_sass_counts_global_loads_by_width():
    """probe sass: a function's global loads by opcode and width, predicated
    ones included; a function with none has none."""
    from nbody_torch.probe import sass_global_loads

    assert sass_global_loads(SUM_SASS) == {"_Zsum": {"LDG.E.128.CONSTANT": 2, "LDG.E": 1},
                                           "_Zplain": {}}


IEEE_SASS = """
        code for sm_90a
                Function : _Zieee
        /*0000*/                   MUFU.RCP R4, R2 ;
        /*0010*/                   FCHK P0, R3, R2 ;
        /*0020*/               @P0 BRA 0x60 ;
        /*0030*/                   FFMA R5, R4, R3, RZ ;
        /*0040*/                   CALL.REL.NOINC 0x80 ;
        /*0050*/                   EXIT ;
                Function : _Zchain
        /*0000*/                   MUFU.RSQ R6, R5 ;
        /*0010*/                   MUFU.RCP R7, R6 ;
        /*0020*/                   EXIT ;
"""


def test_probe_sass_counts_the_ieee_slow_paths():
    """probe sass: a function's CALL and FCHK instructions, the slow paths
    of IEEE division and root; the chain's approximations have none."""
    from nbody_torch.probe import sass_slow_paths

    assert sass_slow_paths(IEEE_SASS) == {"_Zieee": 2, "_Zchain": 0}
