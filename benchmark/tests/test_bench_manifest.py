"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == KEYS["top"]
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(1 <= len(w) <= 200 for w in cmd)
    files = [w for w in cmd if "/" in w]
    assert files and all(any(w.startswith(p + "/") for p in MANIFEST["paths"]) for w in files)


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_have_the_contract_keys(group):
    entries = MANIFEST[group]
    assert entries
    for e in entries:
        assert set(e) - {"workloads"} == KEYS[group], e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
    assert len({e["name"] for e in entries}) == len(entries)


def test_all_names_distinct_across_groups():
    names = [e["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MANIFEST[g]]
    assert len(set(names)) == len(names)


def test_configs_files_and_reduced_keys():
    for c in MANIFEST["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith("benchmark/")
        cfg = json.loads(f.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for k in ("engine", "matcher", "hsv_range", "limits", "stage_kernels", "libraries",
                  "host_threads"):
            assert k in cfg, k
        assert "host_threads" in cfg["assumed"]
        assert cfg["engine"]["number_of_disparities"] == cfg["matcher"]["num_disparities"]
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


def test_cells_find_their_files_by_name():
    configs = {c["name"] for c in MANIFEST["configs"]}
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        tr = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert tr["mode"] in ("run", "step_batch")
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_bounds():
    e2e = {e["name"]: e for e in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in e2e.values():
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")


def _reported(cell: str, kind: str) -> set:
    return {m["name"] for m in MANIFEST[kind] if "workloads" not in m or cell in m["workloads"]}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in MANIFEST["workloads"]:
        e2e = _reported(w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert _reported(w["name"], "per_layer")


def test_per_layer_moves_a_metric_its_cells_report():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {e["name"] for e in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in _reported(cell, "end_to_end")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def test_layers_are_named_alike_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for m in MANIFEST["per_layer"]:
        assert f"**{m['layer']}**" in perf, m["layer"]


def test_run_seconds_fit_the_check_with_24_cells():
    r = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200
