"""Finding a cell's pieces by name.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration and traffic mix; everything else is a file of its own, found
by that name:

- a configuration: `configs/<config>.json`, a whole SLAM config of the
  port plus `source`, `reduced` and `assumed` (JSON: the card's Python
  reads it with the standard library alone);
- its correctness limits: `limits/<config>.json`;
- a traffic mix: `traffic/<traffic>.json`, the parameters the one
  generator of `sequence.py` reads;
- a per-layer metric: `metrics/<metric>.py`, a reader with
  `read(record) -> float | None`.

A new cell, mix or metric is new files and entries: no file here changes."""
from __future__ import annotations

import copy
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

# keys of a configuration file that describe it and are not read by SLAM
DESCRIPTION_KEYS = ("name", "source", "reduced", "assumed", "why")


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict  # the SLAM config as it is run
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries whose workloads take this cell
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def slam_config(path: Path) -> dict:
    """The SLAM config of a configuration file, without its description."""
    raw = load_json(path)
    return {k: v for k, v in raw.items() if k not in DESCRIPTION_KEYS}


def _takes(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None) -> Cell:
    bench = load_json(BENCHMARK) if bench is None else bench
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in {BENCHMARK.name}")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"], chips=int(w["chips"]),
        config=slam_config(ROOT / conf["file"]),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{w['config']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _takes(m, name)],
        per_layer=[m for m in bench["per_layer"] if _takes(m, name)],
    )


def metric_reader(name: str):
    """The `read(record)` function of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sequence_config(config: dict, seed: int, overrides: dict | None = None) -> dict:
    """The SLAM config under run seed `seed`: its street (Dataset.seed) and
    the SLAM's own generator (seed) drawn from the seed, and the mix's
    overrides merged in."""
    import numpy as np

    cfg = copy.deepcopy(config)
    for section, values in (overrides or {}).items():
        cfg.setdefault(section, {}).update(values)
    s_scene, s_slam = np.random.SeedSequence(int(seed)).generate_state(2)
    cfg["Dataset"]["seed"] = int(s_scene)
    cfg["seed"] = int(s_slam)
    return cfg
