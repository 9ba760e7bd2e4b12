"""k4_variants' in-memory edits of csrc/dss.cu, its ptxas report and its
bounds, checked without a card: each named variant's edit finds its target
in dss.cu exactly once and changes the text (so no variant silently times
the as-built kernel), the Shape tables hold the seven launch cases, and
the bytes of each case are chip_smoke.py's."""

import pytest

import chip_smoke
from transport_se_tpu_torch import _build, k4_variants
from transport_se_tpu_torch.ops import dss_face

SRC = (_build.CSRC / k4_variants.SRC).read_text()
VARIANTS = [n for n in k4_variants.edits(SRC) if n != "as_built"]


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_edit_changes_the_source(name):
    edits = k4_variants.edits(SRC)[name]
    assert edits
    s = SRC
    for old, new in edits:
        assert s.count(old) == 1, (name, old)
        assert new != old
        s = s.replace(old, new)
    assert s != SRC


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_shape_tables_cover_the_seven_cases(dtype):
    _, vals = k4_variants.shape_table(SRC, dtype)
    assert set(vals) == set(k4_variants.NAMES)
    for k, v in vals.items():
        assert len(v) == len(dss_face.FACE_CASES) == 7, k
    assert all(w in (1, 2, 4) for w in vals["vec"])
    assert all(t % 32 == 0 and 32 <= t <= 1024 for t in vals["threads"])
    assert all(b >= 1 for b in vals["min_blocks"] + vals["passes"])
    # wide doubles each case's lanes up to 4; one_lane takes one
    block = k4_variants.shape_table(SRC, dtype)[0]
    for name, want in (("wide", [min(2 * w, 4) for w in vals["vec"]]),
                       ("one_lane", [1] * 7)):
        edited = dict(k4_variants.edits(SRC)[name])[block]
        assert k4_variants.shape_table(edited, dtype)[1]["vec"] == want


def test_face_usage_names_each_instance():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115dss_"
        "face_kernelIfLb1ELb0ELb1ELb0ELi2EEEvPKT_PKlS3_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115dss_"
        "face_kernelIdLb0ELb0ELb0ELb0ELi2EEEvPKT_' for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 40 registers",
        # the parent's form: avg, min/max, Laplacian, no lane width
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115dss_"
        "face_kernelIfLb1ELb1ELb1EEEvPKT_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113minmax_"
        "kernelIfLi2EEEvPKT_' for 'sm_90a'",
        "ptxas info    : Used 64 registers"])
    assert k4_variants.face_usage(log) == (
        "f32 avg+minmax+lap 128r/0B, f32 minmax V2 64r/0B, f64 raw V2 40r/8B")


@pytest.mark.parametrize("case", list(dss_face.FACE_CASES))
def test_case_bytes_are_chip_smokes(case):
    flags, scale = dss_face.FACE_CASES[case]
    for es in (4, 8):
        want = chip_smoke.dss_cost(5400, 2520, 72, es, avg=bool(flags & 1),
                                   minmax=bool(flags & 2),
                                   lap=bool(flags & 4), scale=scale)[0]
        assert k4_variants.case_bytes(case, 5400, 2520, 72, es) == want


def test_subcycle_weights_are_chip_smokes():
    assert k4_variants.SUBCYCLE == chip_smoke.K4_SUBCYCLE
    assert sum(k4_variants.SUBCYCLE.values()) == 12


@pytest.mark.parametrize("case", list(dss_face.FACE_CASES))
def test_face_case_gives_the_case_its_flags(case):
    """face_case's arguments make dss_face launch the case's flags (bit 0
    avg, bit 1 min/max, bit 2 Laplacian) with rspheremp where it scales."""
    flags, scale = dss_face.FACE_CASES[case]
    kw = dss_face.face_case(case, "rsp", "avg", "dp", "met", "deriv")
    assert (kw["rsp"] is not None) == scale
    assert (int(kw["avg"] is not None) | int(kw["dp"] is not None) << 1
            | int(kw["met"] is not None) << 2) == flags
    assert (kw["met"] is None) == (kw["deriv"] is None)
