"""The port's trainer, config bundle, checkpoints, dataset and loader.

- `python -m video_gcp_torch.training.train` on toy_random/gcp_tree on the
  CPU in a subprocess: exit 0, finite logged totals, `weights_ep0` written;
  `--resume latest` then trains epoch 1 from it and validates, in a child
  that never loads jax, flax or video_gcp_tpu.
- `--val_metric_batches 1` adds val_psnr/ssim/mse to the validation,
  `--val_sweep 1` validates every saved epoch, and `--metric 1` runs the
  top-of-100 Evaluator: results_<it>.txt, the four channel-first .npy dumps
  under the JAX Evaluator's names, and the eval records.
- Without `--device` and without a GPU the trainer raises;
  `--dataset_val_sweep` on a config without sweep specs raises; a named
  dataset that is not on disk raises with how to generate it.
- The config bundle, the checkpoint resolution, RandomVideoDataset and the
  loader's batches against the JAX package.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from video_gcp_torch.data import loader as t_loader
from video_gcp_torch.data.datasets import RandomVideoDataset, resize_video
from video_gcp_torch.training import checkpoint as t_ckpt
from video_gcp_torch.training.config import build_hparams, load_config, require_dataset
from video_gcp_torch.training.trainer import ModelTrainer, parse_args
from video_gcp_tpu.data.datasets import RandomVideoDataset as JRandomVideoDataset
from video_gcp_tpu.training import checkpoint as j_ckpt
from video_gcp_tpu.training.config import load_config as j_load_config

REPO = Path(__file__).resolve().parent.parent
TOY = "experiments/prediction/toy_random/gcp_tree"
NAV = "experiments/prediction/9room/gcp_tree"
FLAGS = ["--path", TOY, "--feed_random_data", "1", "--deterministic", "1",
         "--device", "cpu"]

_RESUME = """
import sys
from video_gcp_torch.training.trainer import main
main(sys.argv[1:])
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "flax", "video_gcp_tpu")))
"""


def read_events(log_dir):
    with open(log_dir / "events.jsonl") as f:
        return [json.loads(line) for line in f]


def _run(args, exp_dir):
    # two intra-op threads: the test runs beside other test workers
    env = dict(os.environ, PYTHONPATH=str(REPO), GCP_EXP_DIR=str(exp_dir),
               GCP_N_DATA_WORKERS="2", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_trainer_trains_checkpoints_and_resumes(tmp_path):
    out = _run(["-m", "video_gcp_torch.training.train", *FLAGS, "--num_epochs", "1",
                "--skip_first_val", "1", "--verbose_timing", "1"], tmp_path)
    exp = tmp_path / "prediction/toy_random/gcp_tree"
    assert (exp / "weights/weights_ep0/state.pt").is_file()
    assert not (exp / "weights/weights_ep1").exists()
    events = read_events(exp / "events")
    totals = [e["value"] for e in events if e["tag"] == "train_total_loss"]
    assert len(totals) == 7 and all(isinstance(v, float) and np.isfinite(v) for v in totals)
    assert all(e["value"] == 1.0 for e in events if e["tag"] == "train_grads_finite")
    assert "[val]" not in out  # skipped after epoch 0
    assert "epoch 0: median step " in out  # the 'train_step' and 'trainer.data' spans

    out = _run(["-c", _RESUME, *FLAGS, "--num_epochs", "2", "--resume", "latest"],
               tmp_path)
    assert f"resuming from {exp}/weights/weights_ep0" in out
    assert "epoch 1 it 0/64" in out and "epoch 0 it" not in out
    assert "[val] epoch 1" in out
    assert "LOADED []" in out
    assert t_ckpt.get_epochs(exp) == [0, 1]
    state = torch.load(exp / "weights/weights_ep1/state.pt", weights_only=True)
    assert state["step"] == 128  # 64 steps per epoch, counted across the resume
    val = [e for e in read_events(exp / "events") if e["tag"] == "val_total_loss"]
    assert len(val) == 1 and np.isfinite(val[0]["value"])


def test_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelTrainer(parse_args(["--path", TOY, "--feed_random_data", "1"]))


@pytest.mark.parametrize("flag", ["--dataset_val_sweep"])
def test_trainer_flags_not_ported_raise(monkeypatch, tmp_path, flag):
    """--dataset_val_sweep is ported (tests/test_torch_sequential.py runs
    it); on a config without `dataset_sweep_specs` it raises."""
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path))
    trainer = ModelTrainer(parse_args([*FLAGS, flag, "1"]))
    with pytest.raises(ValueError, match="dataset_sweep_specs"):
        trainer.run()


def test_a_missing_dataset_raises_with_how_to_generate_it(monkeypatch, tmp_path):
    monkeypatch.setenv("GCP_DATA_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "nav_9rooms")) as err:
        require_dataset("nav_9rooms")
    assert "experiments/data_gen/nav_9rooms/mod_hyper.py" in str(err.value)
    (tmp_path / "nav_9rooms").mkdir()
    require_dataset("nav_9rooms")  # a directory on disk is used as it is


def test_trainer_val_metrics_and_val_sweep(tmp_path):
    out = _run(["-m", "video_gcp_torch.training.train", *FLAGS, "--num_epochs", "2",
                "--val_metric_batches", "1"], tmp_path)
    exp = tmp_path / "prediction/toy_random/gcp_tree"
    assert "[val] epoch 0" in out and "| psnr" in out
    events = read_events(exp / "events")
    for k in ("val_psnr", "val_ssim", "val_mse"):
        vals = [e["value"] for e in events if e["tag"] == k]
        assert len(vals) == 2 and all(np.isfinite(vals)), k
    assert 0 < vals[0] < 1  # mse in [0, 1]

    out = _run(["-m", "video_gcp_torch.training.train", *FLAGS, "--val_sweep", "1",
                "--val_metric_batches", "0"], tmp_path)
    assert "[val] epoch 0" in out and "[val] epoch 1" in out and "| psnr" not in out
    steps = [e["step"] for e in read_events(exp / "events")[len(events):]
             if e["tag"] == "val_total_loss"]
    assert steps == [64, 128]  # each epoch's checkpoint, at its step


def test_trainer_metric_runs_the_evaluator(tmp_path):
    out = _run(["-m", "video_gcp_torch.training.train", *FLAGS, "--metric", "1"], tmp_path)
    exp = tmp_path / "prediction/toy_random/gcp_tree"
    metrics = exp / "metrics"
    lines = (metrics / "results_0.txt").read_text().splitlines()
    assert [line.split(":")[0] for line in lines] == ["mse", "psnr", "ssim"]
    csv = [line for line in out.splitlines() if line.count(",") == 8]
    assert len(csv) == 1 and all(np.isfinite(float(x)) for x in csv[0].split(","))
    # 32 val sequences of 16 frames at 16x16, channel-first
    shapes = {"gt_seq_0.npy": (32, 15, 3, 16, 16), "gen_images_0.npy": (32, 15, 3, 16, 16),
              "full_gen_seq_0.npy": (32, 15, 3, 16, 16),
              "seq_samples_0.npy": (4, 5, 16, 3, 16, 16)}
    for name, shape in shapes.items():
        a = np.load(metrics / name)
        assert a.shape == shape and np.isfinite(a).all(), name
    events = read_events(exp / "events")
    tags = {e["tag"] for e in events}
    assert {"val_eval_mse", "val_eval_psnr", "val_eval_ssim",
            "_eval/metric/mse/top100_mean", "_eval/verbose/ssim/all100_std"} <= tags
    files = [e["file"] for e in events if "file" in e]
    assert len(files) == 10 and all((exp / "events" / f).is_file() for f in files)
    assert not (exp / "weights").exists()  # evaluates, does not train


def test_trainer_resumes_from_pretrained_npz(monkeypatch, tmp_path):
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path))
    weights = f"{NAV}/pretrained_ep74.npz"
    trainer = ModelTrainer(parse_args(["--path", NAV, "--feed_random_data", "1",
                                       "--device", "cpu", "--resume", weights]))
    want = t_ckpt.flax_to_torch(t_ckpt.load_pretrained_npz(weights))
    got = trainer.model.state_dict()
    # (the npz keeps the scalar log_sigma as [1])
    assert all(torch.equal(got[k], v.reshape(got[k].shape)) for k, v in want.items())
    assert trainer.start_epoch == 0 and trainer.step == 0 and not trainer.optimizer.state
    assert trainer.conf["batch_size"] == 16 and len(trainer.train_loader) == 32


@pytest.mark.parametrize("conf", [NAV, TOY])
def test_config_bundle_matches_jax(conf):
    t, j = load_config(conf), j_load_config(conf)
    assert t.exp_name == j.exp_name
    assert set(t.configuration) == set(j.configuration)
    for k, v in j.configuration.items():
        if k != "model":
            assert t.configuration[k] == v, k
    assert t.configuration["model"].__name__ == j.configuration["model"].__name__
    for k in ("max_seq_len", "n_actions", "state_dim"):
        assert t.data_conf.dataset_spec[k] == j.data_conf.dataset_spec[k]
        assert t.model_config[k] == j.model_config[k]
    assert t.data_conf.fps == j.data_conf.fps
    assert build_hparams(t)["max_seq_len"] == j.data_conf.dataset_spec["max_seq_len"]


@pytest.mark.parametrize("phase,index", [("train", 0), ("train", 17), ("val", 3)])
def test_random_video_dataset_matches_jax(phase, index):
    spec = dict(dataset_spec=dict(max_seq_len=100))
    mpar = dict(img_sz=32)
    t = RandomVideoDataset(None, mpar, _attr(spec), phase)[index]
    j = JRandomVideoDataset(None, mpar, _attr(spec), phase)[index]
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]), err_msg=k)


def _attr(d):
    from video_gcp_torch.core.attrdict import AttrDict

    return AttrDict({k: _attr(v) if isinstance(v, dict) else v for k, v in d.items()})


def test_resize_video_raises_when_a_resize_is_needed():
    """A video at the size is returned as it is; one that needs resizing is
    resized as cv2's INTER_AREA resizes it (tests/test_torch_datasets.py),
    and a resize that OpenCV's area interpolation would mix (down along
    one axis, up along the other) raises."""
    v = np.random.RandomState(0).randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    assert resize_video(v, (8, 8)) is v
    small = resize_video(v, (4, 4))
    assert small.shape == (2, 4, 4, 3) and small.dtype == np.uint8
    assert small[0, 0, 0, 0] == (v[0, :2, :2, 0].astype(int).sum() + 2) >> 2
    with pytest.raises(ValueError, match="downscale along one axis"):
        resize_video(v, (16, 4))


@pytest.mark.parametrize("drop_last,n_repeat", [(True, 2), (False, 1)])
def test_loader_batches(drop_last, n_repeat):
    spec = _attr(dict(dataset_spec=dict(max_seq_len=8)))
    dset = RandomVideoDataset(None, dict(img_sz=8), spec, "val", dataset_size=10)
    loader = t_loader.DataLoader(dset, 4, shuffle=False, n_repeat=n_repeat,
                                 drop_last=drop_last, num_workers=3)
    assert loader.num_workers == min(3, os.cpu_count())
    batches = list(loader)
    assert len(batches) == len(loader) == (5 if drop_last else 3)
    assert batches[0].traj_seq.dtype == torch.uint8
    assert batches[0].traj_seq.shape == (4, 8, 8, 8, 3)
    np.testing.assert_array_equal(batches[1].traj_seq[0].numpy(), dset[4].traj_seq)
    if not drop_last:
        assert batches[-1].end_ind.shape == (2,)


def test_checkpoint_resolution_matches_jax(tmp_path):
    for epoch in (0, 3, 12):
        (tmp_path / "weights" / f"weights_ep{epoch}").mkdir(parents=True)
    (tmp_path / "weights" / "other").mkdir()
    assert t_ckpt.get_epochs(tmp_path) == j_ckpt.get_epochs(str(tmp_path)) == [0, 3, 12]
    for resume in ("latest", "3", 12, "none", None):
        assert t_ckpt.resolve_resume(resume, tmp_path) == j_ckpt.resolve_resume(
            resume, str(tmp_path))
    with pytest.raises(ValueError):
        t_ckpt.resolve_resume("5", tmp_path)
    assert t_ckpt.resolve_resume("latest", tmp_path / "nothing") is None


def test_checkpoint_round_trip(tmp_path):
    from video_gcp_torch.parallel.train_step import make_optimizer

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    opt = make_optimizer(model.parameters(), "radam", 1e-3, 0.5)
    model(torch.randn(5, 3)).sum().backward()
    opt.step()
    path = t_ckpt.save_checkpoint(tmp_path, 4, model, opt, step=9)
    assert path.endswith("weights_ep4")
    model2 = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    opt2 = make_optimizer(model2.parameters(), "radam", 1e-3)
    assert t_ckpt.load_checkpoint(path, model2, opt2) == 9
    for a, b in zip(model.state_dict().values(), model2.state_dict().values()):
        assert torch.equal(a, b)
    assert opt2.param_groups[0]["gradient_clip"] == 0.5
    assert json.dumps(opt2.state_dict()["param_groups"][0]["gradient_clip"]) == "0.5"
