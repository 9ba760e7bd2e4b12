"""BENCHMARK.json against the files it names: every cell finds its
configuration, traffic, limits and readers by name, and every name and
unit keeps to the characters allowed."""

import importlib
import json
import re

from benchmark import harness
from benchmark.reference.transport import LANE_FIELDS

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.fullmatch(n) for n in names), names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    assert {m["name"] for m in SPEC["end_to_end"]} == {
        "throughput", "peak_mem_gib", "setup_s"}


def test_every_cell_finds_its_files():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert set(cell.limits["limits"]) == {
            "first_l2", "first_max", "last_l2", "last_max"}
        assert cell.config["ne"] in (30, 120) and cell.config["nlev"] == 72
    for m in SPEC["per_layer"]:
        assert hasattr(importlib.import_module(
            f"benchmark.readers.{m['name']}"), "read")
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_configurations_are_uncut():
    """Each configuration file holds the source's settings as they are
    run, with nothing reduced."""
    for c in SPEC["configs"]:
        assert c["reduced"] == []
        f = json.loads((harness.ROOT / c["file"]).read_text())
        assert f["np"] == 4 and f["rsplit"] == 3 and f["qsplit"] == 1
        assert f["limiter_option"] == 8 and f["test_case"] in LANE_FIELDS
        ne_tstep_nu = {120: (75.0, 1e13), 30: (300.0, 1e15)}[f["ne"]]
        assert (f["tstep"], f["nu_q"]) == ne_tstep_nu
