"""BENCHMARK.json against the rules it is checked by:
names, units, keys, the files each entry names, and which cells report
which metric."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT_KEYS = ("why", "layer", "source")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert len(MANIFEST["command"]) <= 32
    for word in MANIFEST["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs, each run_seconds + 60,
    # 2 x 90 s of compiling a cell, 1200 s spare, in 43200 s
    assert ((2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180
            + 1200) <= 43200
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_text(section):
    entries = MANIFEST[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end",
                                             "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in TEXT_KEYS:
            if key in e:
                assert 1 <= len(e[key]) <= 200, (e["name"], key)
                assert "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        if section in ("end_to_end", "per_layer"):
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25


def test_metric_names_unique_across_kinds():
    names = [m["name"] for k in ("end_to_end", "per_layer")
             for m in MANIFEST[k]]
    assert len(names) == len(set(names))


def test_configs_files_and_reductions():
    for conf in MANIFEST["configs"]:
        path = REPO / conf["file"]
        assert conf["file"].startswith("benchmark/") and path.exists()
        body = json.loads(path.read_text())
        assert len(conf["reduced"]) <= 16
        for key in conf["reduced"]:
            assert NAME.match(key)
            assert key in body and key in body.get("changed", {})
            assert not (key.endswith("_dim") or key.endswith("_rank")
                        or "size" in key or "width" in key), key
        assert set(body.get("changed", {})) == set(conf["reduced"])
        assert conf["source"].startswith("https://")
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


def test_workloads_files_and_chips():
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists(), w["name"]
        pair = (w["config"], w["traffic"])
        assert pair not in pairs
        pairs.add(pair)
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_every_metric_has_its_reader():
    for kind in ("end_to_end", "per_layer"):
        for m in MANIFEST[kind]:
            assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
            for cell in m.get("workloads", []):
                assert cell in {w["name"] for w in MANIFEST["workloads"]}


def test_each_cell_reports_setup_another_metric_and_a_layer():
    e2e = MANIFEST["end_to_end"]
    for w in MANIFEST["workloads"]:
        mine = [m["name"] for m in e2e if reports(m, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        assert any(reports(m, w["name"]) for m in MANIFEST["per_layer"])
    setup = next(m for m in e2e if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


def test_per_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert m["moves"] != "setup_s"
        cells = m.get("workloads", [w["name"] for w in MANIFEST["workloads"]])
        for cell in cells:
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in MANIFEST["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_paths_hold_only_allowed_names():
    allowed = re.compile(r"^[A-Za-z0-9_.\-/]+$")
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(REPO).as_posix()
        assert allowed.match(rel) and len(rel) <= 200, rel
