"""BENCHMARK.json holds what the harness needs to find, by name, for every
cell: its configuration, traffic and cell files, and a reader for each
per-layer metric it reports; names and units keep to their characters."""
import json
import re
from pathlib import Path

import pytest

from cachebench import metrics

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cachebench"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (ROOT / cfg["file"]).is_file()
    assert (ROOT / "cachebench" / "traffic" / f"{w['traffic']}.json").is_file()
    spec = json.loads((ROOT / "cachebench" / "cells" /
                       f"{cell}.json").read_text())
    assert spec["rate_qps"] > 0 and spec["limits"]
    mine = [m for m in BENCH["per_layer"] if cell in m.get("workloads",
                                                              [cell])]
    assert mine
    for m in mine:
        assert hasattr(metrics.load(m["name"]), "read")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_metrics_move(cell):
    """setup_s and one more end-to-end metric in every cell, and each
    per-layer metric's ``moves`` among the end-to-end metrics of every
    cell that reports it."""
    def mine(m):
        return cell in m.get("workloads", [cell])
    e2e = {m["name"] for m in BENCH["end_to_end"] if mine(m)}
    assert "setup_s" in e2e and len(e2e) >= 2
    moved = {m["moves"] for m in BENCH["per_layer"] if mine(m)}
    assert moved and moved <= e2e - {"setup_s"}


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cut(cfg):
    f = json.loads((ROOT / cfg["file"]).read_text())
    assert f["source"] == cfg["source"]
    assert f["reduced"] == cfg["reduced"]
    assert {"model", "deploy", "published"} <= set(f)


@pytest.mark.parametrize("part,key,value", [
    ("deploy", "index", "ivf"), ("deploy", "key_dtype", "int8"),
    ("deploy", "fused_step", False), ("traffic", "arrivals", "burst")])
def test_a_value_the_harness_does_not_run_is_refused(part, key, value):
    harness = pytest.importorskip("cachebench.harness")
    files = {"deploy": {}, "traffic": {}}
    harness.check_supported(**files)
    files[part][key] = value
    with pytest.raises(SystemExit, match=key):
        harness.check_supported(**files)
    for w in BENCH["workloads"]:
        cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
        harness.check_supported(
            json.loads((ROOT / cfg["file"]).read_text())["deploy"],
            json.loads((ROOT / "cachebench" / "traffic" /
                        f"{w['traffic']}.json").read_text()))
