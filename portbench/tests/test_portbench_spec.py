"""BENCHMARK.json, the cells, configurations, traffic mixes and metric
readers parse and agree, and keep to the benchmark's contract."""

import json
import math
import re

import pytest

from portbench.harness import spec as spec_mod
from portbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PKG = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits_its_time():
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]] \
            + [m["layer"] for m in BENCH["per_layer"]] + [c["source"] for c in BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_roofline_shares_are_named_and_in_percent():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files_and_agrees_with_them(w):
    spec = spec_mod.load(ROOT, w["name"])
    config = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (ROOT / config["file"]).resolve().is_relative_to(PKG)
    assert spec.config["name"] == w["config"] and spec.cell["name"] == w["name"]
    assert set(config["reduced"]) == set(spec.config["reduced"]) <= set(spec.config)
    assert spec.config["fleet_documents"] == spec.cell["pool_dirs"] * spec.cell["docs_per_invocation"]
    assert spec.rules_dir().is_dir() and any(spec.rules_dir().iterdir())
    assert spec.traffic["name"] == w["traffic"]
    assert (PKG / "entries" / f"{spec.traffic['entry']}.py").exists()
    assert (PKG / "traffic" / f"{spec.config['generator']}.py").exists()
    assert {m.name for m in spec.end_to_end} >= {"setup_s", "card_ms_per_kdoc"}
    assert spec.per_layer


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.stem for p in (PKG / "metrics").glob("*.py")}
    assert names == files


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(len(BENCH["workloads"]) / 4))


def test_files_under_paths_are_named_from_name_characters():
    for p in PKG.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
