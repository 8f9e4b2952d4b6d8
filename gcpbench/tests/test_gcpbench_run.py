"""The harness's run on the CPU at a tiny size: what it refuses to run, the
modules it leaves loaded, and `correct` coming out false with the timed
path broken underneath."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gcpbench import run
from gcpbench.tests.conftest import ROOT, TINY, tiny_cell


def _main(args, cwd=ROOT, pythonpath=ROOT):
    env = dict(os.environ, PYTHONPATH=str(pythonpath), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "gcpbench.run", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("jaxlib.xla_client", "video_gcp_tpu.models", "flax", "optax.x", "jax"):
        monkeypatch.setitem(sys.modules, name, None)
        assert name.split(".")[0] in run.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "jaxtyping", None)
    monkeypatch.setitem(sys.modules, "video_gcp_torch_extra", None)
    assert "jaxtyping" not in run.forbidden_modules()
    assert not {"video_gcp_torch", "video_gcp_torch_extra"} & set(run.forbidden_modules())


def test_the_set_up_path_loads_no_jax():
    code = ("import sys, json; from gcpbench import run; "
            "from gcpbench.tests.conftest import TINY, tiny_cell\n"
            "r = run.run_cell(tiny_cell('train.9room'), 3, 0.2, False, device='cpu', "
            "hp_override=TINY)\n"
            "print(json.dumps([run.forbidden_modules(), 'video_gcp_torch' in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], True]


def test_no_result_without_a_card():
    out = _main(["--workload", "train.9room", "--seed", "1", "--seconds", "1"])
    assert out.returncode == 3 and out.stdout == "", out.stderr[-2000:]


def test_an_unknown_workload_exits_2():
    out = _main(["--workload", "no.such", "--seed", "1", "--seconds", "1"])
    assert out.returncode == 2 and out.stdout == ""


def test_no_result_beside_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gcpbench", tmp_path / "gcpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _main(["--workload", "train.9room", "--seed", "1", "--seconds", "1"],
                cwd=tmp_path, pythonpath=tmp_path)
    assert out.returncode != 0 and out.stdout == "", out.stderr[-2000:]


def _correct(cell_name, seed=7):
    r = run.run_cell(tiny_cell(cell_name), seed, 0.2, False, device="cpu", hp_override=TINY)
    return r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["train.9room", "train.25room_long", "eval.25room_long"])
def test_a_sound_tiny_run_is_correct(cell):
    ok, checks = _correct(cell)
    assert ok, checks


@pytest.mark.parametrize("cell", ["train.9room", "eval.25room_long"])
def test_the_traced_run_reads_its_metrics(cell):
    """The traced passes and the readers on the CPU (no device operations:
    the kernels' rooflines find nothing to read and are left out)."""
    r = run.run_cell(tiny_cell(cell), 7, 0.2, True, device="cpu", hp_override=TINY)
    assert r["correct"], r["checks"]
    names = set(r["metrics"])
    assert names and not {n for n in names if "roofline" in n and "dtw" not in n}
    assert r["trace"].window_s > 0 and set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _broken_train_step(monkeypatch, fault):
    from video_gcp_torch.parallel import train_step as ts
    plain = ts.train_step

    def broken(model, optimizer, batch, step, generator, mesh=None):
        if fault == "unchanged":  # the step computes but leaves its state
            monkeypatch.setattr(optimizer, "step", lambda *a, **k: None)
        if fault == "half_batch":  # the mean over the first half of the rows
            rows = len(batch.end_ind) // 2
            batch = type(batch)({k: v[:rows] for k, v in batch.items()})
        if fault == "wrong_beta2":  # RAdam's second moment decays too fast
            for group in optimizer.param_groups:
                group["betas"] = (group["betas"][0], 0.99)
        return plain(model, optimizer, batch, step, generator, mesh)

    monkeypatch.setattr(ts, "train_step", broken)


@pytest.mark.parametrize("cell", ["train.9room", "train.25room_long"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "wrong_beta2"])
def test_a_broken_train_step_is_not_correct(monkeypatch, cell, fault):
    _broken_train_step(monkeypatch, fault)
    ok, checks = _correct(cell)
    assert not ok, checks


@pytest.mark.parametrize("fault", ["altered_answer", "half_samples", "shifted_match"])
def test_a_broken_evaluation_is_not_correct(monkeypatch, fault):
    from video_gcp_torch.evaluation import evaluator
    from video_gcp_torch.ops import dtw
    if fault == "altered_answer":  # one metric moved where it is produced
        plain = evaluator.psnr
        monkeypatch.setattr(evaluator, "psnr", lambda a, b: plain(a, b) * 1.001)
    elif fault == "shifted_match":  # each frame takes the previous frame's node
        plain_dtw = dtw.batched_dtw_alignment

        def shifted(C, end_inds):
            inds, dist = plain_dtw(C, end_inds)
            return torch.cat([inds[:, :1], inds[:, :-1]], 1), dist
        monkeypatch.setattr(dtw, "batched_dtw_alignment", shifted)
    else:  # top-of-50: half of the samples left out
        plain_init = evaluator.Evaluator.__init__

        def half(self, *args, **kwargs):
            plain_init(self, *args, **kwargs)
            self._top_of = max(1, self._top_of // 2)
        monkeypatch.setattr(evaluator.Evaluator, "__init__", half)
    ok, checks = _correct("eval.25room_long")
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["train.9room", "train.25room_long", "eval.25room_long"])
def test_the_control_is_not_correct_on_the_card(card, cell):
    """The reference in TF32 put in the program's place fails a limit at the
    cell's own size; the program passes them."""
    from gcpbench import calibrate, spec
    c = spec.load_cell(cell, ROOT)
    r = calibrate.readings(c, 2**31 + 99, True, device=card)
    assert all(r["program"][k] <= lim for k, lim in c.limits.items()), r
    assert any(r["control"][k] > lim for k, lim in c.limits.items()), r


def test_a_sound_plan_run_is_correct_and_an_altered_plan_is_not(monkeypatch):
    """plan.9room at its own size (the pretrained weights fix it): a sound
    run, then one whose plans come back reversed in time."""
    from gcpbench import spec
    from video_gcp_torch.planning import planner_policy
    cell = spec.load_cell("plan.9room", ROOT)
    cell.mix = dict(cell.mix, pairs=2)
    r = run.run_cell(cell, 5, 0.1, False, device="cpu")
    assert r["correct"], r["checks"]
    plain = planner_policy.ImageCEMPolicy._plan

    def reversed_plan(self, state, goal, step):
        plain(self, state, goal, step)
        self.image_plan = self.image_plan[::-1].copy()
    monkeypatch.setattr(planner_policy.ImageCEMPolicy, "_plan", reversed_plan)
    r = run.run_cell(cell, 5, 0.1, False, device="cpu")
    assert not r["correct"], r["checks"]
