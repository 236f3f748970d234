"""BENCHMARK.json against the benchmark's contract: its keys, names,
units, bounds and `moves`, the files each entry names, and that every cell
reports setup_s, another end-to-end metric and a per-layer metric."""
import json
import math
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in manifest["paths"])
    assert 1 <= len(manifest["command"]) <= 32 and all(one_line(w) for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_unique_and_well_formed(manifest):
    names = [e["name"] for group in ("configs", "workloads", "end_to_end", "per_layer")
             for e in manifest[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metric_entries(manifest, group):
    cells = {w["name"] for w in manifest["workloads"]}
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if group == "end_to_end" else {"layer", "moves"})
    for m in manifest[group]:
        assert set(m) - {"workloads"} == keys, m["name"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert one_line(m["layer"])
            assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()


def test_moves_are_reported_where_read(manifest):
    """A per-layer metric's cells each report the end-to-end metric it moves."""
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)


def test_every_cell_reports_enough(manifest):
    for w in manifest["workloads"]:
        cell = harness.cell(w["name"])
        e2e = [m["name"] for m in cell.metrics(trace=False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.metrics(trace=True), w["name"]
        assert (ROOT / "portbench" / "drivers" / f"{cell.traffic['driver']}.py").is_file()


def test_configs_lie_under_paths(manifest):
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in manifest["paths"])
        with open(ROOT / c["file"]) as f:
            body = json.load(f)
        assert body["reduced"] == c["reduced"] and body["source"] == c["source"]


def test_limits_are_numbers(manifest):
    for w in manifest["workloads"]:
        limits = harness.cell(w["name"]).limits
        assert limits and all(math.isfinite(v["limit"]) and v["limit"] >= 0
                              for v in limits.values())
