"""One closed-loop control run of the port on the CPU, end to end through
`python -m video_gcp_torch.planning.run`'s entry point, on
experiments/control/toy/gcp_tree (16x16 frames, L=5, T=100 env steps).

The port's data generation (experiments/data_gen/nav_9rooms_start_goal, the
PRM expert, raw PNGs) writes the start/goal configuration first; the toy
planner loads a checkpoint of the port's initialisation. Both configs are
copied unchanged under tmp_path, so their logs stay there, and GCP_DATA_DIR
and GCP_EXP_DIR point into it. The run writes task_0.pkl, scores_0to0.pkl and
results_0to0.txt, which the port's and the JAX package's
`compute_control_perf` read to the same numbers.
"""
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from video_gcp_torch.core.attrdict import load_pickle
from video_gcp_torch.evaluation.compute_control_perf import compute_control_perf
from video_gcp_torch.models.hyperparameters import default_hparams
from video_gcp_torch.models.tree import TreeModel
from video_gcp_torch.planning.run import ControlManager, load_control_config
from video_gcp_tpu.evaluation.compute_control_perf import (
    compute_control_perf as j_compute_control_perf,
)

REPO = Path(__file__).resolve().parent.parent
TOY = "experiments/control/toy/gcp_tree/mod_hyper.py"
DATA_GEN = "experiments/data_gen/nav_9rooms_start_goal/mod_hyper.py"


def _copy_config(rel, root):
    dst = root / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / rel, dst)
    return dst


def _toy_setup(tmp_path, monkeypatch, end_idx):
    """Start/goal configurations 0..end_idx from the port's data generation,
    and a toy config copy whose checkpoint is the port's initialisation."""
    monkeypatch.setenv("GCP_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path / "exp"))
    data_gen = _copy_config(DATA_GEN, tmp_path)
    ControlManager([str(data_gen), "--device", "cpu", "--start_idx", "0",
                    "--end_idx", str(end_idx)]).run()
    for i in range(end_idx + 1):
        confs = tmp_path / f"data/nav_9rooms/start_goal_configs/raw/traj_group0/traj{i}"
        assert (confs / "obs_dict.pkl").is_file() and (confs / "images0/im_0.png").is_file()

    toy = _copy_config(TOY, tmp_path)
    policy = load_control_config(toy)["policy"]
    params = dict(policy["params"], batch_size=1)
    hp = default_hparams()
    hp.overwrite(params)
    torch.manual_seed(0)
    ckpt = Path(policy["checkpt_path"]) / "weights/weights_ep0"
    ckpt.mkdir(parents=True)
    torch.save(dict(model=TreeModel(dict(hp)).state_dict(), optimizer={}, step=0),
               ckpt / "state.pt")
    return toy


def test_toy_control_run_on_the_cpu(tmp_path, monkeypatch):
    toy = _toy_setup(tmp_path, monkeypatch, end_idx=0)
    ControlManager([str(toy), "--device", "cpu"]).run()
    log = toy.parent / "log"
    for name in ("task_0.pkl", "scores_0to0.pkl", "results_0to0.txt"):
        assert (log / name).is_file(), name
    task = load_pickle(log / "task_0.pkl")
    assert 1 < len(task["full_traj"]) <= 101
    assert np.isfinite(np.asarray(task["full_traj"], np.float64)).all()
    assert task["goal_image"].shape == (1, 16, 16, 3)

    perf = compute_control_perf(load_pickle(log / "scores_0to0.pkl"), max_seq_len=100)
    with open(log / "scores_0to0.pkl", "rb") as f:
        assert j_compute_control_perf(pickle.load(f), max_seq_len=100) == perf
    assert perf["success_rate"] in (0.0, 1.0)
    assert all(np.isfinite(v) for v in perf.values())
    assert "average pos score" in (log / "results_0to0.txt").read_text()


def test_toy_control_run_in_two_spawned_workers(tmp_path, monkeypatch):
    """--nworkers 2: the config dict pickles into two spawned children, each
    imports the port, plans its own task and writes its own score pickle."""
    toy = _toy_setup(tmp_path, monkeypatch, end_idx=1)
    ControlManager([str(toy), "--device", "cpu", "--nworkers", "2",
                    "--start_idx", "0", "--end_idx", "1"]).run()
    log = toy.parent / "log"
    for i in (0, 1):
        task = load_pickle(log / f"task_{i}.pkl")
        assert np.isfinite(np.asarray(task["full_traj"], np.float64)).all()
        scores = load_pickle(log / f"scores_{i}to{i}.pkl")
        assert len(scores["final_dist"]) == 1
        assert np.isfinite(scores["final_dist"]).all()


def test_control_run_refuses_a_task_the_jax_package_ran(tmp_path, monkeypatch):
    """Both packages log beside the config; a port run does not resume, and so
    report as its own, a task_<i>.pkl that the JAX package wrote."""
    toy = _toy_setup(tmp_path, monkeypatch, end_idx=0)
    log = toy.parent / "log"
    log.mkdir()
    shutil.copy(REPO / "experiments/control/9room/gcp_tree/log_ep74/task_0.pkl",
                log / "task_0.pkl")
    with pytest.raises(RuntimeError, match="written by the JAX package"):
        ControlManager([str(toy), "--device", "cpu"]).run()
    assert not (log / "scores_0to0.pkl").exists()


def test_seeded_runs_repeat(tmp_path, monkeypatch):
    """--seed S seeds each worker's np.random (worker i: S + i): the PRM
    expert's start/goal configurations repeat run for run and differ
    between seeds."""
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path / "exp"))
    starts = {}
    for run, seed in (("a", 3), ("b", 3), ("c", 4)):
        monkeypatch.setenv("GCP_DATA_DIR", str(tmp_path / run))
        data_gen = _copy_config(DATA_GEN, tmp_path / run)
        ControlManager([str(data_gen), "--device", "cpu", "--start_idx", "0",
                        "--end_idx", "0", "--seed", str(seed)]).run()
        confs = tmp_path / run / "nav_9rooms/start_goal_configs/raw/traj_group0/traj0"
        obs = load_pickle(confs / "obs_dict.pkl")
        starts[run] = np.asarray(obs["state"], np.float64)
    assert np.array_equal(starts["a"], starts["b"])
    assert not np.array_equal(starts["a"], starts["c"])
