"""The harness finds every piece of a cell by its name, refuses an unknown
one, and takes a new cell from new files and entries alone."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from gcpbench import spec
from gcpbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(name):
    cell = spec.load_cell(name, ROOT)
    loop = spec.loop_module(cell.mix["kind"])
    for fn in ("setup", "window", "end_to_end", "traced", "unit_numbers", "release",
               "check", "calibration_setup", "program_readings", "reference_readings",
               "fault_readings", "gaps"):
        assert callable(getattr(loop, fn)), fn
    assert cell.limits, "a cell without correctness limits"
    for metric in cell.per_layer:
        assert callable(spec.metric_reader(metric["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"


def test_per_layer_metrics_sit_in_cells_that_report_what_they_move():
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))


def test_an_unknown_cell_is_refused():
    with pytest.raises(spec.UnknownWorkload):
        spec.load_cell("no.such.cell", ROOT)


def test_a_new_cell_takes_only_new_files_and_entries(tmp_path):
    """A copy of the benchmark gains a traffic mix, its limits and a cell
    entry, and runs that cell on the CPU at a tiny size: no file of the
    harness is edited."""
    shutil.copytree(ROOT / "gcpbench", tmp_path / "gcpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "experiments").symlink_to(ROOT / "experiments")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "train.9room.dummy", "config": "gcp_tree.9room",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test's cell"})
    bench["end_to_end"][0]["workloads"].append("train.9room.dummy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = dict(json.loads((ROOT / "gcpbench/traffic/train_full100.json").read_text()),
               batch=2, seq_len=8, pool_batches=8)
    (tmp_path / "gcpbench/traffic/dummy_mix.json").write_text(json.dumps(mix))
    (tmp_path / "gcpbench/limits/train.9room.dummy.json").write_text(
        (ROOT / "gcpbench/limits/train.9room.json").read_text())
    code = (
        "import json; from pathlib import Path; from gcpbench import spec, run\n"
        "from gcpbench.tests.conftest import TINY\n"
        "cell = spec.load_cell('train.9room.dummy', Path('.'))\n"
        "r = run.run_cell(cell, 5, 0.2, False, device='cpu', hp_override=TINY)\n"
        "print(json.dumps(dict(correct=r['correct'], metrics=sorted(r['metrics']))))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"correct": True, "metrics": ["setup_s", "train_frames_per_s"]}
