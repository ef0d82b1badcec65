"""A cell, found by its name: everything of it is in files of its own.

In a checkout (the directory that holds `BENCHMARK.json`):
- the cell's entry in `BENCHMARK.json`'s `workloads`, and its
  configuration's entry in `configs`, whose `file` holds the configuration;
- `benchmarks/mixes/<traffic>.json`, the traffic mix (traffic.py);
- `benchmarks/limits/<cell>.json`, each checked number's limit;
- `benchmarks/metrics/<metric>.py` for each per-layer metric the cell
  reports: a reader with `read(view) -> float | None` (metrics.py);
- the definition file that the configuration's file names under
  `definition` (block.py says what it holds), or, where it names none,
  block.py, the port's block.
A cell's metrics are the end-to-end and per-layer entries that list it
under `workloads`, or that have no `workloads` key (a per-layer one then
where the cell reports the end-to-end metric it moves).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

from . import block

BENCH_DIR = "benchmarks"
# what a definition has to hold; `leaf_scale` is block.py's where it has none
DEFINITION_NAMES = ("leaf_shapes", "sgd_step", "logits", "new_routes",
                    "record", "model_flops", "gemm_work", "attention_work")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: Dict[str, dict]
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable]
    definition: ModuleType

    @property
    def model(self) -> dict:
        return self.config["model"]


def _listed(metric: dict, cell: str, moves=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moves is None or metric["moves"] in moves


def _load_module(path: Path, prefix: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(path: Path) -> Callable:
    return _load_module(path, "bench_metric_").read


def load_definition(path: Path) -> ModuleType:
    module = _load_module(path, "bench_definition_")
    missing = [n for n in DEFINITION_NAMES if not hasattr(module, n)]
    if missing:
        raise AttributeError(f"{path} defines no {', '.join(missing)}")
    if not hasattr(module, "leaf_scale"):
        module.leaf_scale = block.leaf_scale
    return module


def load_cell(name: str, checkout: Path) -> Cell:
    checkout = Path(checkout)
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    root = checkout / BENCH_DIR
    e2e = [m for m in bench["end_to_end"] if _listed(m, name)]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _listed(m, name, moves)]
    limits_file = root / "limits" / f"{name}.json"
    config = json.loads((checkout / conf["file"]).read_text())
    return Cell(
        name=name, chips=entry["chips"], config=config,
        mix=json.loads((root / "mixes" / f"{entry['traffic']}.json")
                       .read_text()),
        limits=(json.loads(limits_file.read_text())
                if limits_file.exists() else {}),
        end_to_end=e2e, per_layer=per_layer,
        readers={m["name"]: load_reader(root / "metrics" / f"{m['name']}.py")
                 for m in per_layer},
        definition=(load_definition(checkout / config["definition"])
                    if "definition" in config else block))
