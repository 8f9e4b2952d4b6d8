"""Resolve a cell of BENCHMARK.json to its files, by name.

A cell names a configuration and a traffic mix. The configuration's entry in
BENCHMARK.json names its file; the mix is `traffic/<mix>.json`, whose `kind`
names the loop `loops/<kind>.py`; the correctness limits are
`limits/<cell>.json`; a per-layer metric is read by `metrics/<metric>.py`.
Adding a cell, a configuration, a mix or a metric adds files and entries and
edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


class UnknownWorkload(LookupError):
    pass


@dataclass
class Cell:
    name: str
    chips: int
    root: Path  # the checkout: BENCHMARK.json's directory
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<mix>.json
    limits: dict  # limits/<cell>.json
    end_to_end: list  # the entries of the metrics this cell reports
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A metric with `workloads` is reported in those cells; without it, in
    every cell (an end-to-end metric) or in every cell that reports the
    end-to-end metric it moves (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path) -> Cell:
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise UnknownWorkload(f"no workload {name!r} in BENCHMARK.json; "
                              f"known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = read_json(root / conf["file"])
    mix = read_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = read_json(HERE / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=w["chips"], root=root, config=config, mix=mix,
                limits=limits, end_to_end=e2e, per_layer=per_layer)


def loop_module(kind: str):
    """`loops/<kind>.py`: setup, window, metrics, profile and check of one
    kind of traffic."""
    return importlib.import_module(f"gcpbench.loops.{kind}")


def metric_reader(name: str):
    """`metrics/<name>.py`'s `read(run)`: the metric's value, or None where
    the run holds nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gcpbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
