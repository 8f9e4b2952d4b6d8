"""The port's tree plots (video_gcp_torch/evaluation/visualization.py)
against the JAX package's (pure numpy in both: equal to the last bit), and
the trainer's image logging on the CPU: a val pass of
toy_random/gcp_tree and of a use_convs=False tree writes its image files,
the dataset's top-down overlay among them."""
import json
import os
from pathlib import Path

import numpy as np
import pytest

from video_gcp_torch.evaluation import visualization as t_vis
from video_gcp_tpu.evaluation import visualization as j_vis

REPO = Path(__file__).resolve().parent.parent


def _case(seed=0, b=2, depth=4, t=9, size=4):
    rng = np.random.RandomState(seed)
    n = 2 ** depth - 1
    return dict(images=(rng.rand(b, n, size, size, 3) * 2.4 - 1.2).astype(np.float32),
                match=rng.rand(b, n, t).astype(np.float32),
                traj=(rng.rand(b, t, size, size, 3) * 2 - 1).astype(np.float32),
                keep=rng.rand(b, n) < 0.5)


@pytest.mark.parametrize("plot, args", [
    ("plot_balanced_tree", ("images",)),
    ("plot_gt_matching_overview", ("images", "match", "traj")),
    ("plot_pruned_seq", ("images", "keep")),
    ("seq_strip", ("traj",)),
])
@pytest.mark.parametrize("i_ex", [0, 1])
def test_plots_equal_jax(plot, args, i_ex):
    case = _case()
    got = getattr(t_vis, plot)(*(case[a] for a in args), i_ex=i_ex)
    want = getattr(j_vis, plot)(*(case[a] for a in args), i_ex=i_ex)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


MAZE_DATA = """
from video_gcp_tpu.data.configs.nav_9rooms import Nav9Rooms


class MazeRandomVideoDataset(RandomVideoDataset):
    # the random data, drawn by the 9-room dataset's top-down renderer
    render_trajectory = Nav9Rooms.render_trajectory


data_config.dataset_spec.dataset_class = MazeRandomVideoDataset
"""


def _conf(tmp_path, name, extra):
    """toy_random/gcp_tree plus `extra`, under a directory whose path holds
    `experiments/` beside the base configs."""
    conf = tmp_path / "experiments" / "prediction" / name
    conf.mkdir(parents=True)
    base = REPO / "experiments/prediction/base_configs"
    os.symlink(base, tmp_path / "experiments" / "prediction" / "base_configs")
    (conf / "conf.py").write_text(
        (REPO / "experiments/prediction/toy_random/gcp_tree/conf.py").read_text()
        + MAZE_DATA + extra)
    return conf


@pytest.mark.parametrize("name, extra, want", [
    ("images", "", {"val_gt_vs_pred", "val_pred_gif", "output_tree", "pruned_pred",
                    "gt_match_overview", "regressed_state_topdown"}),
    ("states", "model_config.update(dict(use_convs=False, input_nc=2, nz_mid_lstm=16))\n",
     {"prediction_topdown", "regressed_state_topdown"}),
], ids=["images", "states"])
def test_trainer_val_pass_logs_images(tmp_path, monkeypatch, name, extra, want):
    from video_gcp_torch.training.logger import Logger
    from video_gcp_torch.training.trainer import ModelTrainer, parse_args

    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path / "exp"))
    monkeypatch.syspath_prepend(str(tmp_path))
    conf = _conf(tmp_path, name, extra)
    trainer = ModelTrainer(parse_args([
        "--path", str(conf), "--feed_random_data", "1", "--num_epochs", "1",
        "--deterministic", "1", "--device", "cpu", "--resume", "none",
        "--val_metric_batches", "1"]))
    trainer.train_loader.dataset.n_seqs = 4  # one step
    trainer.val_loader.dataset.n_seqs = 4
    trainer.run()
    assert isinstance(trainer.logger, Logger) and trainer.step == 1
    events = trainer.logger.log_dir
    records = [json.loads(line) for line in open(os.path.join(events, "events.jsonl"))]
    files = {r["tag"][len("val_"):]: r["file"] for r in records if "file" in r}
    assert set(files) == want, sorted(files)
    for rel in files.values():
        with open(os.path.join(events, rel), "rb") as f:
            head = f.read(8)
        assert head == b"\x89PNG\r\n\x1a\n" or head.startswith(b"GIF8"), rel
