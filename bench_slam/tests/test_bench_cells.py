"""BENCHMARK.json against the contract's shape, and every cell's pieces
found by name."""
import json
import re

import pytest

import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads(cells.BENCHMARK.read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")


def test_names_units_and_links():
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells_ = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells_)) <= cells_
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = cells.find_cell(cell)
    assert c.config["Dataset"]["type"] == "synthetic"
    assert int(c.traffic["periods"]) >= 1
    assert c.limits and all(v >= 0 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(cells.metric_reader(m["name"]))


def test_mix_files_found_by_name():
    for path in (cells.HERE / "traffic").glob("*.json"):
        mix = cells.load_json(path)
        assert {"n_frames", "periods", "check"} <= set(mix)


def test_sequence_configs_differ_by_seed_and_repeat_by_seed():
    c = cells.find_cell(BENCH["workloads"][0]["name"])
    big = 2**31 + 12345
    a, b = cells.sequence_config(c.config, big), cells.sequence_config(c.config, big + 1)
    assert a["Dataset"]["seed"] != b["Dataset"]["seed"] and a["seed"] != b["seed"]
    assert cells.sequence_config(c.config, big) == a
    assert {k: v for k, v in a.items() if k not in ("seed", "Dataset")} == {
        k: v for k, v in c.config.items() if k not in ("seed", "Dataset")}
